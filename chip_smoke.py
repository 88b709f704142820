#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their plain versions.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each failure raises and ends the run with a non-zero exit):

1. Build the five kernel libraries with nvcc for sm_90a, one nvcc each,
   started together: the SGNS lifetime kernel (``kernels/sgns/csrc``), the
   flash attention kernel (``kernels/flash_attention/csrc``), the
   chunked SSD scan's two routes (``kernels/ssm_scan/csrc``: ``ssd_scan.cu``
   and the wide route, ``ssd_wide.cu``) and the embedding server's
   order-pinned scoring kernel (``kernels/chain_dot/csrc``). Print the compiler's
   register/shared-memory report and the card's name and power limit, and
   check in the flash library's SASS that every bf16 kernel
   (``flash_kernel_sm90`` up to head dim 128, ``flash_kernel_sm90_wide``
   at MLA's 288 and ``flash_kernel_sm90_split3`` at 576, each of the last
   two built once with v read apart and once with v = k) issues
   wgmma (``HGMMA``) and TMA loads
   (``UTMALDG``), and in the SSD libraries' that every product kernel runs
   on the tensor cores in TF32 (the first route's two kernels ``HGMMA``
   ... ``TF32``, its C B^T blocks ``HMMA`` ... ``TF32``; the wide route's
   C B^T-and-local-state kernel and its output kernel ``HGMMA`` or
   ``HMMA`` ... ``TF32``).
2. Hold each kernel against its plain torch version on the card: SGNS
   (the TPU kernel's buffer interface) at the paper width and three
   ragged shapes, one of W + K = 16 columns (5e-4); flash attention at the
   reference's test shapes, at every head dim, with GQA, ragged lengths,
   ``q_offset`` and without the causal mask, at the prefill shapes of
   qwen3-1.7b, zamba2-7b, qwen2-moe-a2.7b and chameleon-34b, and without
   the mask at seamless-m4t-large-v2's encoder (4,096 keys) and
   cross-attention (2,048 queries over 4,096 keys) and a ragged 300 over
   1,100 keys (through ``ops.attend``, the model layers' entry, which takes
   the key lengths the reference wrapper refuses) (2e-3 in float32 against
   ``mha_reference``, through the SIMT kernel; 2e-2 in bfloat16, through the wgmma kernel, its error
   against ``mha_chunked`` printed beside); at MLA's latent head dim 288
   with one KV head and MLA's sm_scale, in both types: minicpm3-4b's
   prefill shape with v a tensor of its own, the zero-padded latent and k
   itself (whose first 256 columns must match the padded latent's), a
   ragged Sq with q_offset > 0 and a non-causal case; the same at
   deepseek-v2-lite-16b's latent head dim 576 (512 + 64, sm_scale
   192^-0.5; its prefill shape 4 x 16 x 1,819, its first 512 columns
   against the padded latent's, a ragged Sq with q_offset 256, a
   non-causal case at 512 keys); the SSD scan in the
   reference's 3-D form at its test shapes and chunks and at zamba2's
   prefill shape with the model's decay, where the masked decay overflows
   above the diagonal, and in the mixer's form (strided views, B and C per
   group) at that shape and with two groups of distinct B and C (3e-3
   against ``ssd_chunked_ref``, y and the final state); the SSD scan's
   wide route at the xLSTM's scan shape (P 513, N 512, chunk 512, inputs
   at the mLSTM's scale, where exp(cum) underflows within a chunk) at the
   traffic's longest prompt, at 2,048 steps, at a ragged 1,100 and at
   4,608 (nine chunks), and at the reference's test cases forced through
   it (3e-3, its chunk-state scratch NaN-filled, y and the state finite).
3. The embedding path: ``embed_graph`` with ``PAPER_EMBED`` on the
   ``yt-sim`` R-MAT preset (1,138,499 nodes), first at ``num_shards=2`` (the
   paper's regime: the MPGP partition, the walks on the partition-sharded
   engine, two replicas, the hotness-block sync), then at ``num_shards=1``
   (the dense walk engine). Every walk batch of the k = 2 run must have run
   on the sharded engine, and its InCoM messages (printed) must measure
   the analytic bytes exactly, 80 bytes each (to 1e-5, float32 sums). In
   each run K1 and its write-back must
   have launched once per training step, every step inside a CUDA graph
   replay (replays = chunks), with one hotness sync per 50-step boundary
   crossed at k = 2; phi must be finite and the link-prediction AUC (of the
   replica mean) above 0.75. Then, on a batch of the k = 2 run at S = 2
   replicas (the two runs' embeddings, the k = 2 run's walks and
   negatives), first ``[serve]``, embedding serving: the scoring kernel
   (``chain_dot``) against its plain versions on the card bit for bit at d
   1, 7, 16, 17, 64, 128 and 129 and batches 1, 5, 32 and 40, and through a
   server on the card (pair widths 0-1,024, padded; k 1, 10, 100 and N)
   against the NumPy oracle, on rows with ties, signed zeros and
   subnormals; then an ``EmbedServer`` on the card serving yt-sim: the two
   replicas as version 1 (a snapshot in the reference's layout; the
   replica mean taken on the host must equal NumPy's), waves of 32 top-K
   (k 10, 100), pair (widths 1-1,024) and mixed queries, version 2 (the k
   = 1 run's phi) swapped in past a torn step directory numbered above
   both, a ``swap`` drill on version 3's offer that must leave version 2
   serving, then version 3; every response equal to the plain versions on
   the card for the version it is stamped with (a few also to the NumPy
   oracle on the host), chain_dot launched once per top-K group and pair
   bucket; the kernel's time at a 32-query top-K wave against its bound,
   its plain version's, the library's (a matmul and ``torch.topk``) and the
   top-K sort's, wave wall by kind, the snapshots' save, load, gate and
   offer seconds and peak memory. Then the batch's extents; the SGNS kernel's deltas against
   ``lifetime_deltas_ref``, the write-back of those deltas against
   ``write_back_ref``, the fused step against ``sgns_step_ref`` and two
   50-step chunks (the second hub-heavy, thousands of slots of the hottest
   node a step, and synced) replayed as graphs against the eager chunks
   (phi within 5e-4, tensors allocated between the replays untouched); the
   same two chunks from a clone of the same state through a new graph must
   give bit-equal phi (the write-back adds in a fixed order); K1's times at
   S = 2 and S = 1, and the write-back's and the step's against their
   bounds. Then ``[durable]``: the k = 2 run again as a durable, supervised
   run (the same pipeline, a ``HealthMonitor`` checking every tenth chunk,
   snapshots in the reference's layout every three iterations, two kept,
   in a temporary directory removed at the end) under ``run_with_restarts``
   with a crash at a round, a torn snapshot and a crash at a tail
   iteration; its phi must equal the k = 2 run's bit for bit, K1 launches =
   write-backs = the steps trained, replays included, all in graph
   replays, and one flight record must be dumped per fired fault; then a
   heal drill from the newest tail snapshot: a NaN injected into phi must
   be reported ``nonfinite`` at the first checked chunk, rolled back to the
   snapshot (phi equal to its arrays bit for bit) and the run finished at
   half the learning rate, phi finite, AUC above 0.75; the run telemetry is
   written and read back. Prints each snapshot's bytes and write seconds,
   each resume's seconds and the steps it trained again, and the device
   time a checked chunk adds. Then ``[walk]``: the walks of the first half
   of round 0's sources (``WALK_SHARE``; the k = 2 run's round-0 keys) on
   the dense engine and on the sharded engine, replicated at k =
   2 and partition-local at k = 2 and 4 under MPGP and at k = 4 under the
   hash partition. Each must draw the dense walks bit for bit and count a
   hand-off for every cross-owner hop of its paths (counted on the host),
   at the analytic bytes; each prints its wall time, supersteps, host
   reads, exchange rounds, pool, lane occupancy, CSR bytes per shard and
   peak memory, and MPGP's hand-offs are printed against hash's at k = 4.
   Then ``[spmd]``: (a) the walk engine across processes: two ranks of
   a gloo group (``dist.spawn.run_ranks``) share the card, each loading
   the yt-sim arrays, Cm and the k = 2 MPGP partition that the script
   wrote to a temporary directory, and run the first ``SPMD_WALKS`` of
   ``[walk]``'s k = 2 walks (its sources and round-0 keys; a cut, PERF.md
   §7) through ``run_walk_sharded(mesh=make_walk_mesh(2))``, replicated
   under MPGP (the whole CSR on each rank) and then partition-local under
   ``a2a`` and the hash partition (the graph left on the host, the rank's
   slice on the card): MPGP's k = 2 partition of yt-sim cuts no arc, so
   only under hash do walkers cross ranks (its hand-offs must be > 0).
   Every rank's merged state (paths, info, cur,
   prev, active, h series and ring, accepts, rejects, hand-offs, bytes)
   must hash equal to a stacked run of the same walks in this process,
   its lanes to ``[walk]``'s first lanes of that engine, and each rank's
   SPMD batch counter must read 2; each rank prints wall, supersteps,
   host reads, the backend, its collectives and the bytes staged through
   the host, CSR bytes and peak memory. (b) ``launch.steps.build_train_step`` on a
   one-rank (data, model) ``DeviceMesh`` over NCCL: qwen3-1.7b at full
   width and ``LM_LAYERS`` depth with ``grad_accum`` 2, its parameters,
   moments and batch DTensors and its layers run on DTensors; K2 launched
   2 x (4 forward + 4 recompute) times; its loss, gradient norm, first
   moments (the clipped gradients) and updated parameters against a
   ``grad_accum`` 1 step of the same state and batch on one process,
   within ``SPMD_LOSS_TOL``, ``SPMD_GNORM_TOL``, ``SPMD_MOMENT_TOL`` /
   ``SPMD_LEAF_TOL`` and ``SPMD_MOVED_TOL``.
   Then ``[refresh]``, dynamic graphs in two cases: the ``fl-sim`` preset
   (80,513 nodes at degree 146, 16 rounds resident in the ring) under
   ``PAPER_EMBED``, and the reference's acceptance recipe (rmat 2,048 at
   degree 10, seed 3, its test's config). Each runs
   ``embed_graph(num_shards=2, return_state=True)``, a 5% ``churn_batch``
   (seed 1, timed on the host) and ``refresh_embedding``, and the recipe a
   from-scratch vertex-keyed ``embed_graph`` of the mutated graph. Every slot whose
   pre-update root is unaffected must be bit-identical after the refresh;
   the affected mask must equal an int64 recount on the host from the
   pre-update ring; the first and the last retained round's spliced rows
   must equal a full vertex-keyed round of every source on the mutated
   graph; ocn must move by exactly the tokens written less those replaced;
   the overlay's graph must hold exactly the mutated edge set, and its
   incremental Cm must equal ``edge_common_neighbors`` of it; K1 launches
   = write-backs = fine-tune steps, all in graph replays, a hotness sync at
   each 50-step boundary; phi finite. The recipe is also held to the
   reference's acceptance: at most 30% of the vertices walked again, the
   refreshed AUC within 0.02 of the scratch run's. (On fl-sim the
   low-degree pool's arcs lie on most walks, and the AUC does not rank a
   trained embedding of its R-MAT graph above chance: PERF.md §6.) Each
   prints the churn, the affected count (the churn's endpoints and the
   roots whose walks traverse a changed arc), the rounds, the re-walk's
   walks and supersteps, the arcs and wedges the incremental Cm recounts,
   the refresh's wall time by phase against the base run's (and the
   recipe's scratch run's), the stale and refreshed AUCs (and scratch's)
   and peak memory. On fl-sim two more paths ride on the case.
   ``[elastic]``: after the base run, the same run again (its graph, Cm,
   partition and config) under a liveness probe with walk shard 1 down
   for a round: one death (k = 2 -> 1: MPGP streams its nodes into
   shard 0, its resident walks are walked again) and one re-join (1 -> 2),
   each followed by a snapshot; ring and phi must equal the base run's
   bit for bit, the snapshot after the re-join must resume at k = 2 with
   its phi, K1 launches = write-backs = steps, and, right after that
   snapshot, ``recover_shard_loss(1)`` must restore a ring whose shard-1
   slots were zeroed, bit for bit (the run goes on from it). ``[ingest fl-sim]``: the churn goes through
   ``IngestDriver.submit``, so the drain is the refresh every check above
   holds; the ingest driver publishes to an ``EmbedServer`` on the card,
   whose wave of 32 mixed queries before the submit must be served on the
   ingest driver's first snapshot and after the drain on the drain's, every
   response equal to that version's NumPy oracle bit for bit, chain_dot
   launched once per group, availability 1.0; the WAL must be truncated,
   ``applied_seq`` = ``appended_seq`` = 1 and in the snapshot's meta, and
   ``IngestDriver.recover`` must end on the driven phi. ``[ingest
   recipe]``: from the recipe's pre-churn snapshot, a driver killed after a durable WAL append is recovered from
   the disk, and its drain, failing once at ``refresh_splice`` (restored
   in place, retried), must end on ``refresh_embedding``'s phi, ring and
   ocn bit for bit. Each prints its seconds (reassign, re-join, partition
   rebuilds, re-walks, WAL append and fsync, snapshots).
Phases 4-9 serve each model at full width and a cut depth (``LM_LAYERS``:
4, 27, 8, 8, 4 and 8 layers, an eighth of each model's but a third of
zamba2's and qwen2-moe's; chameleon's 6 in phase 11): the layer counts below are the full
configurations', and every count of launches per prefill scales with the
layers served.

4. The dense LM path: ``Server`` serving qwen3-1.7b at full width (28
   layers, d 2048, bf16, seeded random weights) to 8 requests with
   prompts of 512-2,048 tokens and 32 new tokens each, in waves of 4
   slots over a 4,096-position cache. Flash attention must have launched
   28 times per prefill. A fresh prefill over each wave's prompts plus its
   first n generated tokens (n = 1, 16, 31) must give decode step n's
   logits and every layer's cached k and v; three cache faults must fail
   that check. Then time flash attention at the prefill shape, against
   its plain version and ``scaled_dot_product_attention``.
5. The hybrid LM path: the same traffic served by zamba2-7b at full width
   and depth (81 blocks: 68 Mamba2, 13 attention; d 3584, bf16, seeded
   random weights). The SSD scan must have launched 68 times and flash
   attention 13 times per prefill. The fresh-prefill check also holds
   every Mamba2 layer's conv window and ssm state after step n; the
   three k/v faults and two state faults (the conv window shifted by one,
   a decode step without the decay) must fail it. Then time the SSD scan
   (in the mixer's form, and in the 3-D form on B and C broadcast, beside
   its bounds with B and C per batch and broadcast) and flash attention at
   zamba2's prefill shapes.
6. The recurrent LM path: the same traffic served by xlstm-350m at full
   width and depth (24 blocks: 21 mLSTM, 3 sLSTM; d 1,024, bf16, seeded
   random weights). The wide route must have scanned 21 times per prefill
   and nothing else launched; the fresh-prefill check holds every mLSTM
   state and every sLSTM c, n and h after step n, and two state faults (an
   mLSTM decode step without the decay, the sLSTM state reset before a
   decode step) must fail it. Then the sLSTM loop's share of each wave's
   prefill wall time, and the wide route's time at the prefill shape
   against its plain version, its bound and the 3xTF32 floor, with each of
   its kernels' device time.
7. The MLA LM path: the same traffic served by minicpm3-4b at full width
   and depth (62 layers of multi-head latent attention: d 2,560, 40 heads,
   q_lora_rank 768, the KV latent 256 + rope 32; 4.07 B parameters, bf16,
   seeded random weights). Flash attention must have launched 62 times per
   prefill, on the latent (one KV head, D = 288, k passed as v); the
   fresh-prefill check holds every layer's latent cache (ckv, krope) over
   positions [0, plen + n), and the three cache faults must move it beyond
   its bounds. Then time flash attention at minicpm3-4b's prefill shape
   against its plain version, its bound and two SDPA calls (enable_gqa,
   and k expanded to every head), each with the backend PyTorch picked.
8. The MoE + MLA LM path: the same traffic served by deepseek-v2-lite-16b
   at full width and depth (27 layers, every one MLA on the 512 + 64 latent
   and a mixture of 64 routed experts, top-6, and 2 shared; the reference
   gives every layer the MoE, so 16,210,324,992 parameters, 30.20 GiB in
   bf16, seeded random weights) at its published capacity_factor 1.25.
   Flash attention must have launched 27 times per prefill at D = 576 and
   nothing else (the timed serve runs bare; the dropped (token, slot) pairs
   of each prefill wave and decode step are printed from the same serve run
   again, untimed, with its routings kept). A decode step's capacity is per call (1 for 4
   slots), so the cached decode drops other pairs than a fresh prefill and
   computes something else by design (the reference's too). The
   consistency check therefore serves the same waves again at the no-drop
   capacity_factor E / top_k, where an expert's capacity is the call's
   token count (only inside this check): no pair may drop, and each fresh
   prefill is routed as the served run was, since bf16 rounding decides
   the router's near-ties and the routed experts' large output carries
   each flip through the later layers (how many choices a fresh prefill
   would make otherwise is printed, and so is a fresh prefill of wave 0
   that routes itself). The first MoE layer's router sees no earlier
   routing, so there the decode and a fresh prefill must pick alike for
   all but FIRST_LAYER_FLIPS of the decoded tokens. Decode step n's logits
   and latent cache must then match the fresh prefill (n = 1, 16, 31);
   phase 7's three cache faults
   and two MoE faults in one decode step (gate weights left unnormalised,
   the shared expert skipped) must fail that check. Then time flash
   attention at deepseek's prefill shape.
9. The plain MoE path: the same traffic, serves and checks for
   qwen2-moe-a2.7b (24 layers, MHA 16/16 at D = 128, 60 routed experts in
   64 slots, top-4, one shared MLP of 5,632; 15,146,059,776 parameters,
   28.22 GiB): flash attention 24 times per prefill at D = 128; the k/v
   cache faults of phase 4 and the MoE faults of phase 8. Each model is
   freed before the next is loaded.

10. LM training (``[train]``): (a) each autograd wrapper on the card with
   seeded inputs and one fixed upstream gradient (``kernels.grad_check``):
   K2 at qwen3-1.7b's training shape (4 x 16 x 2,048, Hkv 8, D 128), at
   zamba2's D 112, at MLA's latents (D 288 and 576, v = k); K3's first
   route at zamba2's mixer shape, its wide route at the xLSTM's scan
   (P 513, N 512, chunk 512) at S 600, and the 3-D form, each with and
   without a gradient on the final state. The forward must lie within the
   kernel's tolerance of the plain forward and every input gradient must
   be bit-equal to the plain forward + backward(). (b) qwen3-1.7b at full
   width and depth (28 layers, d 2,048, GQA 16/8, vocab 151,936, bf16
   params, float32 AdamW moments, remat per block) takes TRAIN_STEPS steps
   of batch 4 x seq 2,048 from ``TokenStream`` through
   ``make_train_step``: every loss and gradient norm finite, the lr
   cosine_warmup's, K2 launched exactly twice per layer and step (the
   forward and the remat recompute; the backward is the plain version's)
   and nothing else; prints step ms, tokens/s and peak memory. (c) The
   restart drill at full width and ``LM_LAYERS``' depth:
   ``Trainer.run_with_restarts`` crashed at step 1 (before the first
   checkpoint) and at step 3 must end with params and moments bit-equal to
   an uninterrupted ``Trainer.run`` from the same seeded state, the
   restore adding no second state on the card; checkpoints in a temporary
   directory removed after; prints a checkpoint's bytes and the save and
   restore seconds. Phase (a) also holds K2 without the mask at seamless's
   cross-attention in training (2 x 16 x 2,048 queries over 1,024 frames,
   D 64).
11. Encoder-decoder models and front ends (``[encdec]``): (b)
   seamless-m4t-large-v2 at full width and depth (24 encoder + 24 decoder
   layers, d 1,024, 16 heads of 64, d_ff 8,192, vocab 256,208; seeded
   random weights, bf16) through ``zoo.prefill_fn`` / ``zoo.decode_fn``
   (the reference has no encoder-decoder server): two waves of 4 prompts,
   2,048 tokens over ``audio_frames`` of 4,096 frames and 512 tokens over a
   ragged 1,100, 32 greedy tokens each over a 4,096-position cache. K2
   must launch 72 times a prefill (encoder, decoder self-attention and
   cross-attention in every layer) and never in a decode step; decode step
   n's logits and self k/v must match a fresh prefill over the same frames
   and tokens (n = 1, 16, 31) within qwen3-1.7b's bounds, and the cross
   k/v bit for bit (decode never writes them). (c) chameleon-34b at full
   width and 6 of its 48 layers through ``lm_path`` (phase 4's checks and
   faults), its prompts ``vq_token_stream`` ids. (d) Two ``Trainer`` steps
   of seamless at full width and 2 + 2 layers, batch 2 x 2,048 target
   tokens over 1,024 frames (the Trainer's frames branch; no checkpoint
   written): losses finite, K2 launched 24 times (12 forward, 12 in the
   remat recompute). (a) K2's check cases at the encoder's, the
   cross-attention's and a ragged non-causal shape hold its error both at
   ``FLASH_TOL`` and at ``bench.SCALED_TOL`` of the outputs' scale (those
   outputs are as small as ``FLASH_TOL``). Then K2's times at the encoder, cross and chameleon
   shapes against the plain version, the bound and SDPA (``is_causal``
   as the call's).

One worker process (spawned at the start, stopped at the end) makes the
host-only inputs while the card runs the phases before them: the yt-sim
and fl-sim graphs (numpy), fl-sim's churn batch and ``[walk]``'s k = 4
MPGP partition. Each path runs with every launch count set to 0 just
before it and read just after. Prints one JSON line with the kernels' numbers (flash
attention's at qwen3-1.7b's prefill shape, under ``by_shape`` at every
model's, under ``train`` the training step's, under ``encdec`` seamless's
prefill, decode and training times) and, last, the device line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SGNS_TOL = 5e-4
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
PAPER_SHAPE = dict(G=64, W=2, T=100, D=128, K=5, window=10)
RAGGED_SHAPES = [dict(G=5, W=2, T=37, D=96, K=5, window=10),
                 dict(G=7, W=3, T=23, D=128, K=4, window=5),
                 dict(G=6, W=2, T=30, D=128, K=14, window=4)]     # W + K = 16 columns
CHUNK_STEPS = 50                 # one sync_period: the chunk held as a graph against eager
# The reference's flash-attention test cases (tests/test_kernels.py):
# (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype).
FLASH_CASES = [(1, 1, 1, 128, 128, 64, c, 0, "float32") for c in (True, False)] + \
              [(2, 2, 2, 256, 256, 32, c, 0, "float32") for c in (True, False)] + \
              [(1, 4, 4, 512, 512, 64, c, 0, "float32") for c in (True, False)] + \
              [(2, 1, 1, 384, 384, 128, True, 0, "float32"),
               (1, 2, 2, 256, 256, 64, True, 0, "float32"),
               (1, 2, 2, 256, 256, 64, True, 0, "bfloat16"),
               (1, 2, 2, 128, 256, 64, True, 128, "float32")] + \
              [(1, 2, 2, 256, 256, 112, True, 0, dt) for dt in ("float32", "bfloat16")] + \
              [(2, 4, 4, 200, 200, 112, False, 0, "float32")] + \
              [(1, 16, 8, 1000, 1000, 128, True, 0, "bfloat16"),
               (2, 4, 2, 200, 200, 16, True, 0, "bfloat16"),
               (2, 2, 2, 256, 256, 32, False, 0, "bfloat16"),
               (1, 2, 2, 128, 256, 64, True, 128, "bfloat16"),
               (1, 4, 2, 333, 333, 96, True, 0, "bfloat16"),
               (2, 4, 4, 200, 200, 112, False, 0, "bfloat16")]
# K2 on MLA's latent: (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, v) at D =
# 288 with MLA_SCALE and at D = 576 with DEEPSEEK_SCALE, in both types; v a
# tensor of its own, the zero-padded latent, or k itself. minicpm3-4b's and
# deepseek-v2-lite-16b's prefill shapes are added in main().
MLA_SCALE = (64 + 32) ** -0.5      # minicpm3-4b: (qk_nope_dim + qk_rope_dim) ** -0.5
DEEPSEEK_SCALE = (128 + 64) ** -0.5    # deepseek-v2-lite-16b, at D = 576
MLA_FLASH_CASES = [(1, 4, 1, 77, 333, 288, True, 256, "k"), (2, 4, 1, 200, 512, 288, False, 0, "k"),
                   (2, 8, 1, 333, 333, 288, True, 0, "own"),
                   (1, 4, 1, 77, 333, 576, True, 256, "k"), (2, 4, 1, 200, 512, 576, False, 0, "k"),
                   (2, 8, 1, 333, 333, 576, True, 0, "own")]
SSD_TOL = 3e-3
# The reference's SSD kernel test cases (tests/test_kernels.py):
# (BH, S, P, N, chunk).
SSD_CASES = [(2, 64, 16, 8, 32), (4, 128, 32, 16, 32), (1, 200, 64, 32, 32),
             (3, 96, 8, 64, 32)] + [(2, 128, 16, 8, q) for q in (16, 64, 128)]
# The mixer's form (B, H, G, S, P, N, chunk): two groups of distinct B and C.
SSD_GROUP_CASES = [(2, 8, 2, 300, 64, 64, 128)]
# The wide route at the mLSTM's scan (B, H, S, P, N, chunk), G = H: four full
# chunks, a ragged S and nine chunks (the chain); the traffic's longest
# prompt is added in main().
WIDE_MLSTM_CASES = [(4, 4, 2048, 513, 512, 512), (4, 4, 1100, 513, 512, 512),
                    (4, 4, 4608, 513, 512, 512)]
LM_ARCH = "qwen3-1.7b"
HYBRID_ARCH = "zamba2-7b"
RECURRENT_ARCH = "xlstm-350m"
MLA_ARCH = "minicpm3-4b"
MOE_MLA_ARCH = "deepseek-v2-lite-16b"
MOE_ARCH = "qwen2-moe-a2.7b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "chameleon-34b"
#: Phases 4-9 serve each model at full width and these depths, to keep the
#: script inside its time limit on a slower host (PERF.md §5): an eighth of
#: the layers (one block cycle at least), but a third of zamba2's and
#: qwen2-moe's, whose checks need them (at 11 blocks zamba2's bf16 decode
#: drifts past its logits bound; at 3 layers a skipped shared expert no
#: longer moves qwen2-moe's cache and logits past theirs).
LM_LAYERS = {LM_ARCH: 4, HYBRID_ARCH: 27, RECURRENT_ARCH: 8, MLA_ARCH: 8, MOE_MLA_ARCH: 4,
             MOE_ARCH: 8, VLM_ARCH: 6}
LM_REQUESTS, LM_NEW_TOKENS, LM_SLOTS, LM_MAX_LEN = 8, 32, 4, 4096
LM_PROMPT_LENS = (512, 2048)
KV_CHECK_STEPS = (1, 16, 31)
# An MoE model at the no-drop capacity factor: the share of decoded tokens
# (every wave at KV_CHECK_STEPS) whose picks in the first MoE layer may
# differ from a fresh prefill's. Measured 0 of 12 in wave 0 on both MoE
# models (H100, PERF.md); flips start at the second to seventh layer,
# where the earlier layers' rounding has reached the router's input.
FIRST_LAYER_FLIPS = 0.125
# Decode against a fresh prefill: the logits, of the largest |logit|, and
# the served caches, of each tensor's largest entry, per layer (attention
# k and v; Mamba2's conv window and ssm state). Each bound sits well above
# what the correct bf16 model measures on an H100 and well below what the
# injected faults give (PERF.md): qwen3-1.7b logits 0.00625, k/v 0.01255,
# faults 0.79-0.99; zamba2-7b logits up to 0.028, k/v 0.111, conv 0.083,
# ssm 0.081 (these move by up to 2x between runs: 1e-5 changes in K3's
# output reround differently through 81 bf16 blocks), k/v faults
# 0.69-1.00, conv fault 1.56, ssm fault 1.15. In float32 zamba2's decode
# equals a fresh prefill within 1e-3 (tests/test_torch_zamba2.py, on the
# card): the rest is bf16 rounding that differs between the batched
# prefill and the one-token decode. xlstm-350m (mLSTM matrix memory; sLSTM
# c, n, h): the correct bf16 model drifts further, and more with each step
# (n = 1: logits 0.019-0.021, states up to 0.073; n = 31: logits up to
# 0.184, mlstm 0.124, c 0.136, n 0.118, h 0.529; which elements round which
# way, and so each maximum, moves with any change to the rounding: logits
# 0.094 before k / sqrt(P) was rounded as the reference rounds it), against
# faults of mlstm 1.099 (decode without the decay) and c 1.052 (sLSTM state
# reset). The JAX reference drifts as much in bf16: on the CPU at the
# reduced config the port's mean drift of each kind is 0.84-1.68x the
# reference's, and the mixers' states match the reference's within 2e-4
# through 31 bf16 decode steps (tests/test_torch_xlstm.py); in float32 the
# port's decode equals a fresh prefill within 1.8e-4 after 1, 16 and 31
# steps at full width on the card (the same file's card test). minicpm3-4b
# (the MLA latent cache, ckv and krope, compared over positions [0, plen +
# n)): logits 0.0093, ckv 0.0157, krope 0.0160; faults: cache length -1 or
# +1 ckv 0.988, the rope phase +1 krope 0.935 (ckv 0.032: the latent
# carries no phase); in float32 its decode equals a fresh prefill within
# 3.2e-6 (tests/test_torch_mla.py, on the card). The MoE models, at the
# no-drop capacity factor with each fresh prefill routed as the served run
# was (moe_consistency): deepseek-v2-lite-16b logits 0.141, ckv 0.115,
# krope 0.097; qwen2-moe-a2.7b logits 0.109, k/v 0.127 (the routed
# experts' output, ~100x the attention's at the reference's init, carries
# bf16 rounding far; left to route itself a fresh prefill differs in most
# picks of the last layers and by 0.73-1.20 of the largest logit); faults:
# deepseek cache length -1 / +1 ckv 1.282 / 0.988, rope phase +1 krope
# 0.920, gate weights unnormalised logits 1.213 and ckv 1.122, shared
# expert skipped logits 0.772, ckv 0.598, krope 0.534; qwen2-moe k/v
# 1.206 / 0.902 / 1.060, unnormalised logits 1.401, shared skipped logits
# 1.126 and k/v 0.791. In float32 at full width (4 layers) deepseek's
# decode equals a fresh prefill within 1e-3 (tests/test_torch_moe.py, on
# the card).
BOUNDS = {"qwen3-1.7b": {"logits": 2e-2, "kv": 5e-2},
          "zamba2-7b": {"logits": 6e-2, "kv": 0.3, "conv": 0.3, "ssm": 0.3},
          "xlstm-350m": {"logits": 0.2, "mlstm": 0.5, "c": 0.5, "n": 0.4, "h": 0.9},
          "minicpm3-4b": {"logits": 5e-2, "ckv": 0.1, "krope": 0.1},
          "deepseek-v2-lite-16b": {"logits": 0.35, "ckv": 0.3, "krope": 0.3},
          "qwen2-moe-a2.7b": {"logits": 0.35, "kv": 0.35},
          # [encdec]: qwen3-1.7b's bounds, untightened (PERF.md §6 gives the
          # measured drift)
          "seamless-m4t-large-v2": {"logits": 2e-2, "kv": 5e-2},
          "chameleon-34b": {"logits": 2e-2, "kv": 5e-2}}
#: [encdec] (b): seamless-m4t-large-v2 at full width and depth, two waves of
#: LM_SLOTS prompts through zoo.prefill_fn / decode_fn, LM_NEW_TOKENS greedy
#: tokens each over a LM_MAX_LEN self cache: (prompt tokens, source frames);
#: the first wave's source is zoo.CROSS_SRC_LEN frames, the second's ragged.
ENCDEC_WAVES = ((2048, 4096), (512, 1100))
#: [encdec] (d): Trainer steps of seamless at full width and a cut depth,
#: batch x seq_len target tokens over seq_len // 2 source frames.
ENCDEC_TRAIN_LAYERS, ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 2, 2, 2, 2048
# [encdec] (a): K2 checks at the new routes' shapes, (B, Hq, Hkv, Sq, Skv, D,
# causal, q_offset, dtype): seamless's encoder (non-causal over the whole
# source) and cross-attention (a wave's prompt over its source), a ragged
# non-causal one in both types; chameleon's prefill is added in main(). The
# non-causal ones are also held to the outputs' scale (bench.SCALED_TOL).
ENCDEC_FLASH_CASES = [(LM_SLOTS, 16, 16, 4096, 4096, 64, False, 0, "bfloat16"),
                      (LM_SLOTS, 16, 16, 2048, 4096, 64, False, 0, "bfloat16")] + \
                     [(2, 16, 16, 300, 1100, 64, False, 0, dt) for dt in ("float32", "bfloat16")]
H100_F32_FLOPS = 67e12          # FP32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# --- SGNS lifetime (K1) -----------------------------------------------------

def sgns_inputs(torch, G, W, T, D, K, window, seed, device, invalid=True):
    """Buffers as the main path gathers them: N(0, 0.1) rows, walks that end
    early (-1 padding) and have holes at random positions when ``invalid``."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: (torch.randn(*s, generator=gen) * 0.1).to(device)
    ctx, out, neg = rnd(G, W, T, D), rnd(G, W, T, D), rnd(G, T, K, D)
    if invalid:
        lengths = torch.randint(0, T + 1, (G, W), generator=gen)
        valid = (torch.arange(T)[None, None, :] < lengths[:, :, None]) \
            & (torch.rand(G, W, T, generator=gen) > 0.1)
    else:
        valid = torch.ones(G, W, T, dtype=torch.bool)
    return ctx, out, neg, valid.to(device)


def sgns_compare(torch, got, want, what: str) -> float:
    """Max abs error over the buffers; raises outside the tolerance."""
    err = 0.0
    for name, a, b in zip(("ctx", "out", "neg"), got[:3], want[:3]):
        if not torch.allclose(a, b, atol=SGNS_TOL, rtol=SGNS_TOL):
            raise AssertionError(f"{what}: {name} differs by "
                                 f"{(a - b).abs().max().item():.3e}")
        err = max(err, (a - b).abs().max().item())
    lk, lr_ = got[3], want[3]
    if not torch.all((lk - lr_).abs() <= SGNS_TOL * lr_.abs().clamp_min(1.0)):
        raise AssertionError(f"{what}: loss differs by {(lk - lr_).abs().max().item():.3e}")
    return err


def sgns_bound_ms(torch, walks, negs, dim, window) -> tuple:
    """Least time for K1 on an H100 on these ids: the bytes it must move
    (the walk and negative ids read once, each live slot's row read once
    and its delta written once, the losses written), over the memory rate,
    against the f32 FMAs the valid (row, column) pairs need (logits, C
    update, T update) over the f32 peak. A live slot is a valid walk token
    (its context and its target row) or a negative at a position where some
    walk has a valid target. Returns (ms, "bytes" | "operations")."""
    W, T = walks.shape[-2:]
    K = negs.shape[-1]
    v = (walks >= 0).reshape(-1, W, T).to(torch.int64)
    lifetimes = v.shape[0]
    live_pos = v.amax(dim=1)                         # (L, T)
    rows_moved = 2 * int(v.sum()) + K * int(live_pos.sum())
    nbytes = (walks.numel() + negs.numel()) * 4 + 2 * rows_moved * dim * 4 + lifetimes * 4
    pad = torch.nn.functional.pad(v, (window, window))
    # valid context positions p-w..p+w (minus p) of walk w, where walk w's target is valid
    win = sum(pad[:, :, window + o: window + o + T] for o in range(-window, window + 1) if o)
    rows = (win * v).sum(dim=1)                      # (L, T) valid rows per position
    cols = v.sum(dim=1) + K                          # (L, T) valid columns
    flops = 2 * 3 * dim * int((rows * cols).sum())
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def writeback_bound_ms(torch, walks, negs, n_rows, dim) -> tuple:
    """Least time for the write-back on an H100 on these ids: the ids read
    once, each live slot's delta read once, each row it touches read and
    written once, over the memory rate (its adds are far below the f32
    peak). Returns (ms, "bytes")."""
    s_cnt, W, T = walks.shape[0], walks.shape[-2], walks.shape[-1]
    K = negs.shape[-1]
    rep = torch.arange(s_cnt, device=walks.device).view(-1, *[1] * (walks.dim() - 1))
    valid = walks >= 0
    live_pos = valid.any(dim=-2)                     # (S, G, T)
    ctx_rows = (walks.long() + rep * n_rows)[valid]
    neg_rows = (negs.long() + rep * n_rows).flatten()
    live = int(valid.sum()) * 2 + int(live_pos.sum()) * K
    touched = ctx_rows.unique().numel() + torch.cat([ctx_rows, neg_rows]).unique().numel()
    nbytes = (walks.numel() + negs.numel()) * 4 + live * dim * 4 + 2 * touched * dim * 4
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def sgns_padded_bound_ms(G, W, T, D, K) -> float:
    """PR 11-14's bound, for comparison: every padded (G, W, T, d) and
    (G, T, K, d) buffer read and written whole, and the int32 mask."""
    nbytes = 2 * (2 * G * W * T * D + G * T * K * D) * 4 + G * W * T * 4 + G * 4
    return nbytes / H100_BYTES_PER_S * 1e3


def sgns_main_path(torch, np, phi_in, phi_out, corpus, device) -> dict:
    """K1, its write-back and the step on a batch of the embedding run at
    S = 2 replicas (phi_in and phi_out (2, N, d) from the run; 64 lifetimes a
    replica of its walks; negatives from its counts): the kernel's deltas
    against ``lifetime_deltas_ref``, the write-back of those deltas against
    ``write_back_ref``, the fused step against ``sgns_step_ref`` and two
    50-step chunks (the second hub-heavy, ending with a hotness sync)
    replayed as CUDA graphs against the eager chunks (phi within SGNS_TOL;
    tensors allocated between the replays untouched), each on copies of
    phi; then the repeatability check: the same two chunks from a clone of
    the same state, through a new graph, give bit-equal phi. Then the
    times: K1 at S = 2 and at S = 1, the step and the write-back. Raises
    outside the tolerance. Returns the kernel line's numbers."""
    from repro_torch.core import dsgl
    from repro_torch.core.corpus import FrequencyOrder
    from repro_torch.core.sync import sample_hotness_rows
    from repro_torch.kernels.sgns import ops, ref

    G, W, T, D, K, w = (PAPER_SHAPE[k] for k in ("G", "W", "T", "D", "K", "window"))
    S = phi_in.shape[0]
    rng = np.random.default_rng(1)
    pick = lambda n: torch.as_tensor(
        corpus.walks[rng.choice(corpus.num_walks, n * S * G * W, replace=False)],
        device=device).reshape(n, S, G, W, T)
    walks = pick(1)[0]                                          # (S, G, W, T) int32
    table = dsgl.build_alias_table(corpus.ocn, 0.75, device)
    negs = dsgl.chunk_negatives(table, (0, 1), (1, S, G, W, T), K)[0]
    lr = torch.full((1,), 0.025, device=device)

    lo, hi = ref.lifetime_extent(walks)
    extent = torch.where(hi >= 0, hi - lo + 1, 0).flatten().sort().values.tolist()
    live = ref.live_slots(walks)[1].sum(dim=-1).flatten().sort().values.tolist()
    L = S * G
    ext = {"min": extent[0], "median": extent[L // 2], "max": extent[-1]}
    log(f"[sgns] main-path batch: {S} x {G} lifetimes, valid tokens "
        f"{(walks >= 0).float().mean().item():.4f}; extent (positions visited) min "
        f"{ext['min']} median {ext['median']} max {ext['max']}; live positions min "
        f"{live[0]} median {live[L // 2]} max {live[-1]}")

    got = ops.lifetime_deltas(phi_in, phi_out, walks, negs, lr, w)
    want = ref.lifetime_deltas_ref(phi_in, phi_out, walks, negs, lr, w)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("d_ctx", "d_out", "d_neg", "loss"),
                          (got.d_ctx, got.d_out, got.d_neg, got.loss), want):
        e = (a - b).abs().max().item()
        if not torch.allclose(a, b, atol=SGNS_TOL, rtol=SGNS_TOL):
            raise AssertionError(f"K1 on the main-path batch: {name} differs by {e:.3e}")
        err = max(err, e) if name != "loss" else err
    log(f"[check] K1 deltas on the main-path batch (S = {S}): max abs err {err:.3e}")

    def phi_err(what, a, b):
        e = max((x - y).abs().max().item() for x, y in zip(a, b))
        if not all(torch.allclose(x, y, atol=SGNS_TOL, rtol=SGNS_TOL) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: phi differs by {e:.3e}")
        log(f"[check] {what}: phi max abs err {e:.3e}")
        return e

    wb, wb_plain = [phi_in.clone(), phi_out.clone()], [phi_in.clone(), phi_out.clone()]
    launched = ops.WRITEBACKS
    ops.write_back(*wb, walks, negs, got)
    ref.write_back_ref(*wb_plain, walks, negs, got.d_ctx, got.d_out, got.d_neg)
    torch.cuda.synchronize()
    if ops.WRITEBACKS != launched + 1:
        raise AssertionError("the write-back did not count its launch")
    wb_err = phi_err("write-back of the kernel's deltas vs its plain version", wb, wb_plain)
    del wb_plain

    step = [phi_in.clone(), phi_out.clone()]
    plain = [phi_in.clone(), phi_out.clone()]
    ops.sgns_step(*step, walks, negs, lr, w)
    ref.sgns_step_ref(*plain, walks, negs, lr, w)
    torch.cuda.synchronize()
    err = max(err, phi_err("fused step vs its plain version, main-path batch", step, plain))
    del plain

    # Two chunks of the run's walks; the second hub-heavy (the run's hottest
    # node in a tenth of all walk slots, thousands a step) and synced.
    first, second = pick(CHUNK_STEPS), pick(CHUNK_STEPS)
    hub = int(np.argmax(corpus.ocn))
    second[torch.rand(second.shape, generator=torch.Generator().manual_seed(3)).to(device)
           < 0.1] = hub
    hub_slots = int((second[0] == hub).sum())
    order = FrequencyOrder.from_ocn(corpus.ocn)
    rows = torch.as_tensor(order.to_node[sample_hotness_rows(
        *order.hotness_blocks(), np.random.default_rng(2))].astype(np.int64), device=device)
    lrs = np.linspace(0.025, 0.02, CHUNK_STEPS, dtype=np.float32)
    state = [phi_in.clone(), phi_out.clone()]
    runs = {}

    def chunks(name, graphs, after_capture=None):
        phi = [state[0].clone(), state[1].clone()]
        train = graphs.train_chunk if graphs is not None else dsgl.train_chunk
        train(*phi, first, table, (0, 2), lrs, w, K)
        if after_capture is not None:
            after_capture()
        train(*phi, second, table, (0, 3), lrs, w, K, sync_rows=rows, sync=True)
        runs[name] = phi

    # Tensors of the step scratch's sizes, allocated after the capture, must
    # come through the next replay untouched: a replay writes only into
    # memory its graph holds.
    n_keys = 2 * S * G * W * T + S * G * T * K
    held = []
    allocate = lambda: held.extend(torch.full(shape, 7.0, device=device) for shape in (
        (S, G, W, T, D), (S, G, W, T, D), (S, G, T, K, D), (S * G,), (n_keys,), (2 * n_keys,)))
    counts = ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS
    chunks("graph", dsgl.ChunkGraphs(), allocate)
    chunks("again", dsgl.ChunkGraphs())
    chunks("eager", None)
    torch.cuda.synchronize()
    if (ops.LAUNCHES - counts[0], ops.WRITEBACKS - counts[1],
            dsgl.GRAPH_REPLAYS - counts[2]) != (6 * CHUNK_STEPS, 6 * CHUNK_STEPS, 4):
        raise AssertionError("the graph chunks did not count their launches and replays")
    if not all(bool((h == 7.0).all()) for h in held):
        raise AssertionError("a graph replay wrote into memory allocated after its capture")
    err = max(err, phi_err(f"two {CHUNK_STEPS}-step chunks (S = {S}; the second hub-heavy, "
                           f"{hub_slots} slots of node {hub} a step, and synced over "
                           f"{len(rows)} hotness rows) as CUDA graph replays vs eager "
                           "(memory allocated between the replays untouched)",
                           runs["graph"], runs["eager"]))
    if not (torch.equal(runs["graph"][0], runs["again"][0])
            and torch.equal(runs["graph"][1], runs["again"][1])):
        diff = (runs["graph"][0] - runs["again"][0]).abs().max().item()
        raise AssertionError(f"the same two chunks from the same state differ by {diff:.3e}")
    log(f"[check] repeatability: the same two {CHUNK_STEPS}-step chunks (one hub-heavy, one "
        "synced) from a clone of the same state through a new graph: phi bit-equal")
    synced = runs["graph"][0][:, rows]
    if not torch.equal(synced[0], synced[1]):
        raise AssertionError("the synced rows differ across the replicas")
    del runs, held

    k1 = lambda: ops.lifetime_deltas(phi_in, phi_out, walks, negs, lr, w, scratch=got)
    k1_ms = time_ms(torch, k1, 50)
    s1 = ops.StepScratch.empty((1, G, W, T), K, D, device)
    k1_s1_ms = time_ms(torch, lambda: ops.lifetime_deltas(
        phi_in[:1], phi_out[:1], walks[:1], negs[:1], lr, w, scratch=s1), 50)
    step_ms = time_ms(torch, lambda: ops.sgns_step(*step, walks, negs, lr, w), 50)
    wb_ms = time_ms(torch, lambda: ops.write_back(*step, walks, negs, got), 50)
    wb_plain_ms = time_ms(torch, lambda: ref.write_back_ref(
        *step, walks, negs, got.d_ctx, got.d_out, got.d_neg), 10)
    plain_ms = time_ms(torch, lambda: ref.lifetime_deltas_ref(phi_in, phi_out, walks, negs,
                                                               lr, w), 5)
    k1_ms2 = time_ms(torch, k1, 50)
    del s1
    bound, by = sgns_bound_ms(torch, walks, negs, D, w)
    wb_bound, wb_by = writeback_bound_ms(torch, walks, negs, phi_in.shape[1], D)
    padded = sgns_padded_bound_ms(S * G, W, T, D, K)
    us_pos = k1_ms / max(ext["max"], 1) * 1e3
    log(f"[time] K1 on the main-path batch (S = {S}): kernel {k1_ms:.4f} ms (again "
        f"{k1_ms2:.4f}), {us_pos:.3f} us per position of the longest extent; at S = 1 "
        f"(replica 0) {k1_s1_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bound:.6f} ms ({by}; "
        f"live rows), padded-buffer bound {padded:.6f} ms")
    log(f"[time] write-back (keys, stable sort, row segments) {wb_ms:.4f} ms, plain "
        f"{wb_plain_ms:.4f} ms, bound {wb_bound:.6f} ms ({wb_by}); step (K1 + write-back) "
        f"{step_ms:.4f} ms")

    del step, got
    return {"max_abs_err": max(err, wb_err), "ms": k1_ms, "ms_s1": k1_s1_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "padded_bound_ms": padded,
            "step_ms": step_ms, "us_per_position": us_pos, "extent": ext,
            "writeback_ms": wb_ms, "writeback_plain_ms": wb_plain_ms,
            "writeback_bound_ms": wb_bound, "writeback_max_abs_err": wb_err}


def embedding_path(torch, np, counters, graph, shards: int, dev) -> dict:
    """``embed_graph(PAPER_EMBED, num_shards=shards)`` on the graph, every
    launch count set to 0 just before it and read just after: K1 and its
    write-back must have launched once per training step, every step inside
    a CUDA graph replay (replays = chunks), one hotness sync per 50-step
    boundary crossed (the reference's rule) with k > 1; phi finite and the
    link-prediction AUC of the replica mean above 0.75. Returns the run's
    phi, corpus and counts."""
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core import dsgl, incom, shard_engine
    from repro_torch.core.api import embed_graph
    from repro_torch.eval import link_prediction_auc
    from repro_torch.kernels.sgns import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].LAUNCHES = 0
    ops.WRITEBACKS = 0
    dsgl.GRAPH_REPLAYS = 0
    shard_engine.BATCHES = 0
    t0 = time.perf_counter()
    phi_in, phi_out, corpus, stats = embed_graph(
        graph, PAPER_EMBED, num_shards=shards, return_corpus=True, return_stats=True,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, writebacks, replays = ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS
    others = {name: c.LAUNCHES for name, c in counters.items() if name != "sgns_lifetime"}
    tag = f"[main k={shards}]"
    ws = stats["stats"]
    part = (f"partition {stats['part_s']:.2f} s (MPGP, DFS+degree: locality "
            f"{stats['locality']:.6f}, balance {stats['balance']:.6f}, nodes per part "
            f"{stats['part_counts']}), " if shards > 1 else "")
    log(f"{tag} embed_graph wall {wall:.2f} s: Cm {stats['cm_s']:.2f} s, {part}pipeline "
        f"{stats['wall_s']:.2f} s (walks {ws['phase_s']['walk']:.2f} s, training "
        f"{ws['phase_s']['train']:.2f} s)")
    log(f"{tag} walks/round {graph.num_nodes} rounds {stats['rounds']} training steps "
        f"{stats['steps']} in {stats['chunks']} chunks, {stats['syncs']} hotness syncs "
        f"({stats['sync_bytes']:.0f} bytes); K1 launches {launches}, write-backs {writebacks}, "
        f"CUDA graph replays {replays}; other kernels {others}")
    log(f"{tag} mean walk length {ws['mean_len']:.4f} supersteps {ws['supersteps']} "
        f"per batch {ws['batch_supersteps']} accepts {ws['accepts']} rejects {ws['rejects']}")
    log(f"{tag} D history {ws['d_history']}")
    count, sent, analytic = ws["msg_count"], ws["msg_bytes"], ws["msg_bytes_analytic"]
    log(f"{tag} walk batches on the sharded engine {shard_engine.BATCHES}; InCoM messages "
        f"{count}, bytes measured {sent!r}, analytic {analytic!r} "
        f"({sent / max(count, 1):.6f} bytes a message)")
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batches = len(ws["batch_supersteps"])
    if shard_engine.BATCHES != (batches if shards > 1 else 0):
        raise AssertionError(f"{shard_engine.BATCHES} walk batches on the sharded engine of "
                             f"{batches} at k = {shards}")
    if sent != analytic or abs(sent - incom.MSG_BYTES * count) > 1e-5 * incom.MSG_BYTES * count \
            or (shards == 1 and count):
        raise AssertionError(f"messages {count}: {sent!r} bytes measured, {analytic!r} "
                             "analytic")
    if launches != stats["steps"] or writebacks != stats["steps"] \
            or replays != stats["chunks"]:
        raise AssertionError(f"K1 launches {launches} and write-backs {writebacks} for "
                             f"{stats['steps']} training steps, {replays} graph replays for "
                             f"{stats['chunks']} chunks: every step must run in a replayed chunk")
    want_syncs = stats["steps"] // dsgl.DSGLConfig().sync_period if shards > 1 else 0
    if stats["syncs"] != want_syncs:
        raise AssertionError(f"{stats['syncs']} hotness syncs, the reference's rule gives "
                             f"{want_syncs}")
    if not (torch.isfinite(phi_in).all() and torch.isfinite(phi_out).all()):
        raise AssertionError("phi is not finite")
    t0 = time.perf_counter()
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    log(f"{tag} link-prediction AUC {auc:.6f} ({time.perf_counter() - t0:.2f} s)")
    if not auc > 0.75:
        raise AssertionError(f"AUC {auc} <= 0.75")
    return {"phi_in": phi_in, "phi_out": phi_out, "corpus": corpus, "launches": launches,
            "writebacks": writebacks, "replays": replays,
            "assignment": stats.get("assignment")}


WALK_RUNS = (("replicated", 2, "mpgp"), ("local", 2, "mpgp"), ("local", 4, "mpgp"),
             ("local", 4, "hash"))
#: ``[walk]`` walks the first 1 / WALK_SHARE of round 0's sources (the
#: lanes draw what they draw in the full round), to keep the script inside
#: its time limit (PERF.md §5).
WALK_SHARE = 2


def walk_hops(np, paths, part) -> int:
    """Consecutive path entries whose owners differ: the hand-offs the
    returned walks imply, counted on the host."""
    hops = 0
    for lo in range(0, paths.shape[0], 1 << 18):
        p = paths[lo:lo + (1 << 18)]
        a, b = p[:, :-1], p[:, 1:]
        hops += int(((a >= 0) & (b >= 0) & (part[np.maximum(a, 0)]
                                            != part[np.maximum(b, 0)])).sum())
    return hops


def state_digest(np, st, lanes=None) -> str:
    """sha256 over a merged walk state: with ``lanes`` the first ``lanes``
    lanes' fields (paths, info, cur, prev, active, h series, ring), else
    every lane's and the batch's counts (supersteps, accepts, rejects,
    hand-offs, bytes). Equal digests are equal states."""
    import hashlib

    h = hashlib.sha256()
    cut = slice(None) if lanes is None else slice(0, lanes)
    fields = [getattr(st, n) for n in ("cur", "prev", "path", "h_series", "hring", "active")]
    fields += [getattr(st.info, f) for f in ("H", "L", "EH", "EL", "EHL", "EH2", "EL2")]
    for t in fields:
        h.update(np.ascontiguousarray(t[cut].cpu().numpy()).tobytes())
    if lanes is None:
        for name in ("accepts", "rejects", "msg_count", "msg_bytes", "msg_bytes_analytic"):
            h.update(np.ascontiguousarray(getattr(st, name).cpu().numpy()).tobytes())
        h.update(str(int(st.supersteps)).encode())
    return h.hexdigest()


def walk_phase(torch, np, graph, dev, parts=None) -> dict:
    """Round 0's first 1 / WALK_SHARE of the sources' walks on the graph,
    ``PAPER_EMBED``'s spec and the k = 2 pipeline's round-0 keys, five times: the dense engine, then the sharded
    engine replicated at k = 2 (MPGP), partition-local at k = 2 and 4
    (MPGP) and at k = 4 under the hash partition (``parts`` holds the
    partitions made already, (k, name) -> assignment). Each sharded run must
    draw the dense run's walks bit for bit (paths, lengths, accepts,
    rejects), count a hand-off for every cross-owner hop of its paths (on
    the host) and measure the bytes the closed form gives. Prints each
    run's wall time, supersteps, host reads, exchange and spill rounds,
    pool, lane occupancy, CSR bytes per shard and peak memory, and MPGP's
    hand-offs against the hash partition's at k = 4. Returns the digests
    of the k = 2 MPGP runs' first ``SPMD_WALKS`` lanes by engine, for
    ``[spmd]``."""
    from repro_torch import prng
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core import incom, mpgp
    from repro_torch.core.api import make_walk_plan
    from repro_torch.core.shard_engine import run_walk_sharded
    from repro_torch.core.walker import LaneKeys, run_walk_batch

    t0 = time.perf_counter()
    graph = graph.with_edge_cm()
    policy, spec, _ = make_walk_plan(PAPER_EMBED)
    n = graph.num_nodes
    key_walk = prng.split(prng.PRNGKey(PAPER_EMBED.seed), 2 + 2)[0]
    walks = n // WALK_SHARE
    keys = lambda: LaneKeys.for_round(prng.fold_in(key_walk, 0), 0, walks, dev)
    sources = torch.arange(walks, device=dev)
    parts = dict(parts or {})
    for k, name in sorted({(k, name) for _, k, name in WALK_RUNS} - set(parts)):
        t1 = time.perf_counter()
        fn = mpgp.mpgp_partition if name == "mpgp" else mpgp.hash_partition
        parts[k, name] = fn(graph, k).assignment
        log(f"[walk] {name} k={k}: partition {time.perf_counter() - t1:.2f} s, nodes per "
            f"part {np.bincount(parts[k, name], minlength=k).tolist()}")
    log(f"[walk] set-up (Cm, partitions) {time.perf_counter() - t0:.2f} s; the k = 2 MPGP "
        f"partition is [main k=2]'s; {walks} walks (round 0's sources 0..{walks - 1})")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dense = run_walk_batch(graph, sources, keys(), policy, spec)
    torch.cuda.synchronize()
    log(f"[walk] dense: wall {time.perf_counter() - t1:.3f} s, supersteps {dense.supersteps}, "
        f"host reads {dense.supersteps + 1}, accepts {int(dense.accepts)}, rejects "
        f"{int(dense.rejects)}, mean length {float(dense.info.L.mean()):.4f}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    handoffs, digests = {}, {}
    for engine, k, name in WALK_RUNS:
        part = parts[k, name]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, stats = run_walk_sharded(graph, sources, keys(), policy, spec, part, k,
                                     engine=engine, with_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2**30
        tag = f"[walk] {engine} k={k} {name}"
        same = (torch.equal(st.path, dense.path) and torch.equal(st.info.L, dense.info.L)
                and (st.supersteps, int(st.accepts), int(st.rejects))
                == (dense.supersteps, int(dense.accepts), int(dense.rejects)))
        count, sent, analytic = int(st.msg_count), float(st.msg_bytes), \
            float(st.msg_bytes_analytic)
        hops = walk_hops(np, st.path.cpu().numpy(), part)
        handoffs[k, name] = count
        log(f"{tag}: wall {wall:.3f} s, supersteps {st.supersteps}, host reads "
            f"{stats['host_reads']}, exchange rounds {stats.get('exchange_rounds', '-')} "
            f"(spill {stats.get('spill_rounds', 0)}), pool {stats.get('pool_slots', '-')} slots "
            f"cap {stats.get('exchange_cap', '-')} retries {stats.get('pool_retries', 0)}, peak "
            f"lane occupancy {stats.get('peak_lane_occupancy', '-')}, CSR bytes per shard "
            f"{stats.get('csr_bytes_per_shard', '-')}, peak device memory {peak:.3f} GiB")
        log(f"{tag}: walks equal the dense engine's {same}; hand-offs {count} "
            f"(per shard {stats['msg_count']}), cross-owner hops on the host {hops}; bytes "
            f"measured {sent!r}, analytic {analytic!r}")
        if not same:
            raise AssertionError(f"{tag}: the walks differ from the dense engine's")
        if (k, name) == (2, "mpgp"):
            digests[engine] = state_digest(np, st, SPMD_WALKS)
        if count != hops or sent != analytic or \
                abs(sent - incom.MSG_BYTES * count) > 1e-5 * incom.MSG_BYTES * count:
            raise AssertionError(f"{tag}: {count} hand-offs for {hops} hops, {sent!r} bytes "
                                 f"for {analytic!r}")
        del st
    m, h = handoffs[4, "mpgp"], handoffs[4, "hash"]
    log(f"[walk] k=4 hand-offs: MPGP {m} against hash {h} "
        f"({(1 - m / max(h, 1)) * 100:.4f}% fewer, {m * incom.MSG_BYTES} against "
        f"{h * incom.MSG_BYTES} bytes)")
    log(f"[walk] phase {time.perf_counter() - t0:.2f} s")
    return digests


# --- [spmd]: the walk engine across processes, the step builder on a mesh -------

SPMD_RANKS = 2
SPMD_TIMEOUT_S = 300.0
#: [spmd] (a) walks the first SPMD_WALKS of [walk]'s sources (each lane draws
#: what it draws there): over gloo with the host staging, a superstep costs
#: ~21-26 ms at 32,768 walks on the card (PERF.md §5), and [walk]'s ~570,000
#: would not fit the script's time (PERF.md §7: the cut).
SPMD_WALKS = 16_384
#: (engine, partition) of [spmd] (a)'s runs. MPGP's k = 2 partition of
#: yt-sim cuts no arc, so under it no walker crosses; the local engine runs
#: under the hash partition, which ships records between the ranks.
SPMD_RUNS = (("replicated", "part"), ("local", "hash"))
#: [spmd] (b): the grad_accum 2 step on the mesh against a grad_accum 1 step
#: of the same state and batch (bf16 parameters and gradients, float32
#: accumulators and moments). Adam's first update is nearly the same for
#: any gradient (m / sqrt(v) is sign(g)), and the clip divides the moments
#: by the norm, so the norm holds the gradient's size and the first moments
#: ((1 - b1) times the clipped gradient) its direction. The limits are
#: relative errors (SPMD_MOVED_TOL the share of parameter elements whose
#: update differs), set from the readings of PERF.md §6 on an H100: loss
#: 7.709e-08, grad norm 3.098e-06, moments 2.879e-03 over all leaves and
#: 3.077e-03 at the worst leaf (each microbatch's bf16 gradient rounded once
#: more than the whole batch's), 5.289e-04 of the elements moved apart.
SPMD_ACCUM = 2
SPMD_STEP = 1                   # lr 0.5 * 3e-4: build_train_step(total_steps=10) warms up 2 steps
SPMD_LOSS_TOL = 1e-6
SPMD_GNORM_TOL = 1e-5
SPMD_MOMENT_TOL = 6e-3          # over all leaves
SPMD_LEAF_TOL = 6e-3            # the worst leaf
SPMD_MOVED_TOL = 1e-3


def spmd_walk_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of ``[spmd]`` (a): load the host arrays, run the replicated
    and the partition-local a2a engines on the walk mesh and return each
    run's state digest, counts and costs."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core import shard_engine
    from repro_torch.core.api import make_walk_plan
    from repro_torch.core.shard_engine import make_walk_mesh, run_walk_sharded
    from repro_torch.core.walker import LaneKeys
    from repro_torch.dist import collectives as col
    from repro_torch.graph.csr import CSRGraph

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    load = lambda name: np.load(os.path.join(job["dir"], f"{name}.npy"))
    host = CSRGraph(indptr=torch.from_numpy(load("indptr")),
                    indices=torch.from_numpy(load("indices")),
                    edge_cm=torch.from_numpy(load("edge_cm")))
    mesh = make_walk_mesh(world)
    policy, spec, _ = make_walk_plan(PAPER_EMBED)
    key_walk = prng.split(prng.PRNGKey(PAPER_EMBED.seed), 2 + 2)[0]
    keys = lambda: LaneKeys.for_round(prng.fold_in(key_walk, 0), 0, job["walks"], dev)
    sources = torch.arange(job["walks"], device=dev)
    out = {"load_s": time.perf_counter() - t0, "runs": {}}
    for engine, part_name in SPMD_RUNS:
        # The replicated engine reads the whole CSR on the card; the local
        # one is given the host graph and moves only its slice there.
        graph = host.to(dev) if engine == "replicated" else host
        csr = sum(t.numel() * t.element_size() for t in (graph.indptr, graph.indices,
                                                         graph.edge_cm))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        col.reset_pg_stats()
        torch.distributed.barrier()
        t1 = time.perf_counter()
        st, stats = run_walk_sharded(graph, sources, keys(), policy, spec, load(part_name),
                                     world, mesh,
                                     engine=engine, with_stats=True,
                                     transport="a2a" if engine == "local" else None)
        torch.cuda.synchronize()
        out["runs"][engine, part_name] = {
            "wall_s": time.perf_counter() - t1, "digest": state_digest(np, st),
            "lanes_digest": state_digest(np, st, job["walks"]),
            "supersteps": int(st.supersteps), "msg_count": int(st.msg_count),
            "host_reads": stats["host_reads"], "exchange_rounds": stats.get("exchange_rounds"),
            "spill_rounds": stats.get("spill_rounds"), "pool": stats.get("pool_slots"),
            "retries": stats.get("pool_retries"),
            "csr_bytes": csr if engine == "replicated" else stats["csr_bytes_per_shard"][rank],
            "collectives": col.PG_STATS["collectives"],
            "staged_bytes": col.PG_STATS["staged_bytes"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del st, graph
    out.update(backend=torch.distributed.get_backend(), spmd_batches=shard_engine.SPMD_BATCHES,
               device=str(dev))
    return out


def _clone_tree(tree):
    """Fresh local storage for every DTensor leaf (the mesh step updates its
    own copy in place)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(tree.to_local().clone(), tree.device_mesh, tree.placements,
                              run_check=False)


def spmd_step_check(torch, np, counters, cfg, dev) -> dict:
    """``[spmd]`` (b): ``build_train_step`` with ``grad_accum`` 2 on a
    one-rank (data, model) mesh against a ``grad_accum`` 1 step on one
    process, from one state and batch; K2's launches counted over the mesh
    step alone."""
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import reshard_to_mesh
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.optim.optimizers import init_opt_state, opt_specs
    from repro_torch.optim.schedules import cosine_warmup

    cfg2 = dataclasses.replace(cfg, grad_accum=SPMD_ACCUM)
    opt_cfg = steps.default_opt(cfg2)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_per_shard=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in stream.batch_at(0).items()}
    base = zoo.init_params(cfg, seed=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = make_host_mesh(1, 1, "cuda")
            pspecs = zoo.param_specs(cfg2)
            params = _clone_tree(reshard_to_mesh(base, mesh, pspecs))
            opt = reshard_to_mesh(init_opt_state(base, opt_cfg), mesh, opt_specs(pspecs, opt_cfg))
            step = steps.build_train_step(cfg2, total_steps=10, mesh=mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(torch, counters)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch, SPMD_STEP)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: mod.LAUNCHES for name, mod in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = [p.to_local() for p in leaves(params)]
            got_m = [t.to_local() for t in leaves(opt["m"])]
            loss, gnorm = float(m["loss"]), float(m["gnorm"])
            del opt, params
        finally:
            dist.destroy_process_group()
    one = steps.build_train_step(cfg, total_steps=10)
    base, opt1, m1 = one(base, init_opt_state(base, opt_cfg), batch, SPMD_STEP)
    lr = float(cosine_warmup(3e-4, 2, 10)(SPMD_STEP))
    worst, over, n, changed = 0.0, 0, 0, 0
    for a, b in zip(got, leaves(base)):
        d = (a.detach().float() - b.detach().float()).abs()
        # Adam's first step moves an element by about lr (m / sqrt(v) is
        # sign(g)): a gradient whose sign the accumulation's rounding flips
        # moves it by up to 2 lr; plus one bf16 rounding of the parameter.
        bound = 2 * lr + b.float().abs() * 2.0 ** -7 + 1e-7
        worst = max(worst, float(d.max()))
        over += int((d > bound).sum())
        changed += int((d > 0).sum())
        n += d.numel()
    num = den = 0.0
    leaf_rel = []
    for a, b in zip(got_m, leaves(opt1["m"])):
        dd = float(torch.sum(torch.square(a.float() - b.float())))
        nn = float(torch.sum(torch.square(b.float())))
        num, den = num + dd, den + nn
        leaf_rel.append((dd / nn) ** 0.5 if nn else (0.0 if dd == 0 else float("inf")))
    del got, got_m, opt1
    rel = abs(loss - float(m1["loss"])) / abs(float(m1["loss"]))
    g_rel = abs(gnorm - float(m1["gnorm"])) / float(m1["gnorm"])
    m_rel, m_leaf = (num / den) ** 0.5, max(leaf_rel)
    moved = changed / n
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = SPMD_ACCUM * 2 * block_kinds(cfg).count("a")
    log(f"[spmd] step builder: {cfg.name} {cfg.num_layers} layers on a one-rank (data, model) "
        f"mesh over nccl, grad_accum {SPMD_ACCUM}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, step "
        f"{SPMD_STEP} (lr {lr:.6g}), against grad_accum 1 (relative errors, each with its "
        f"limit): loss {loss:.6f} / {float(m1['loss']):.6f} {rel:.3e} ({SPMD_LOSS_TOL}), grad "
        f"norm {gnorm:.6f} / {float(m1['gnorm']):.6f} {g_rel:.3e} ({SPMD_GNORM_TOL}), first "
        f"moments {m_rel:.3e} over all leaves ({SPMD_MOMENT_TOL}), worst leaf {m_leaf:.3e} "
        f"({SPMD_LEAF_TOL}); parameters: {changed} of {n} elements differ ({moved:.3e}, "
        f"{SPMD_MOVED_TOL}), max |diff| {worst:.3e}, {over} past 2 lr + |p| 2^-7; step wall "
        f"{wall * 1e3:.1f} ms, peak device memory {peak:.3f} GiB; launches {launches}")
    if launches != expected:
        raise AssertionError(f"[spmd] step builder launches {launches}, expected {expected}")
    if not (np.isfinite(loss) and rel <= SPMD_LOSS_TOL and g_rel <= SPMD_GNORM_TOL and
            m_rel <= SPMD_MOMENT_TOL and m_leaf <= SPMD_LEAF_TOL and moved <= SPMD_MOVED_TOL
            and not over):
        raise AssertionError("[spmd] the grad_accum 2 step on the mesh is off the grad_accum 1 "
                             "step")
    return {"launches": launches, "wall_ms": wall * 1e3, "loss_rel": rel, "gnorm_rel": g_rel,
            "moment_rel": m_rel, "moment_leaf_rel": m_leaf, "moved": moved, "max_abs": worst}


def spmd_stacked(torch, np, graph, parts: dict, walks: int, dev) -> dict:
    """The stacked engine's k = 2 runs of ``[spmd]``'s walks in this
    process: {(engine, partition): (digest with the counts, digest of the
    lanes)}."""
    from repro_torch import prng
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core.api import make_walk_plan
    from repro_torch.core.shard_engine import run_walk_sharded
    from repro_torch.core.walker import LaneKeys

    policy, spec, _ = make_walk_plan(PAPER_EMBED)
    key_walk = prng.split(prng.PRNGKey(PAPER_EMBED.seed), 2 + 2)[0]
    out = {}
    for engine, part_name in SPMD_RUNS:
        t0 = time.perf_counter()
        st = run_walk_sharded(graph, torch.arange(walks, device=dev),
                              LaneKeys.for_round(prng.fold_in(key_walk, 0), 0, walks, dev),
                              policy, spec, parts[part_name], SPMD_RANKS, engine=engine)
        out[engine, part_name] = (state_digest(np, st), state_digest(np, st, walks))
        log(f"[spmd] stacked {engine} k={SPMD_RANKS} {part_name}, {walks} walks: "
            f"{time.perf_counter() - t0:.3f} s, supersteps {st.supersteps}, hand-offs "
            f"{int(st.msg_count)}")
    return out


def spmd_phase(torch, np, counters, arrays_dir: str, graph, parts: dict, walk_lanes: dict,
               cfg, dev) -> dict:
    """``[spmd]``: (a) two ranks on the card against the stacked engine's
    runs of the same walks and against ``[walk]``'s first lanes
    (``walk_lanes``), (b) the step builder on a one-rank mesh."""
    from repro_torch.dist.spawn import run_ranks

    t0 = time.perf_counter()
    walks = SPMD_WALKS
    stacked = spmd_stacked(torch, np, graph, parts, walks, dev)
    for (engine, part_name), (_, lanes) in stacked.items():
        # Walks do not depend on the partition: every run draws [walk]'s lanes.
        if lanes != walk_lanes[engine]:
            raise AssertionError(f"[spmd] stacked {engine} {part_name}: the first {walks} "
                                 "lanes differ from [walk]'s")
    t1 = time.perf_counter()
    out = run_ranks(spmd_walk_rank, SPMD_RANKS, "gloo", "cuda", SPMD_TIMEOUT_S,
                    {"dir": arrays_dir, "walks": walks})
    log(f"[spmd] {SPMD_RANKS} ranks on {out[0]['device']} over {out[0]['backend']} (NCCL "
        f"refuses two ranks on one device; the collectives stage CUDA tensors through the "
        f"host), the first {walks} of [walk]'s walks, {len(SPMD_RUNS)} runs: "
        f"{time.perf_counter() - t1:.2f} s with the ranks' start")
    for rank, r in enumerate(out):
        for (engine, part_name), run in r["runs"].items():
            log(f"[spmd] rank {rank} {engine}{' a2a' if engine == 'local' else ''} {part_name}: "
                f"wall "
                f"{run['wall_s']:.3f} s, supersteps {run['supersteps']}, host reads "
                f"{run['host_reads']}, exchange rounds {run['exchange_rounds']} (spill "
                f"{run['spill_rounds']}), pool {run['pool']} retries {run['retries']}, "
                f"hand-offs {run['msg_count']}, {run['collectives']} collectives, "
                f"{run['staged_bytes']} bytes staged through the host, CSR bytes on the card "
                f"{run['csr_bytes']}, peak device memory {run['peak_gib']:.3f} GiB; state "
                f"equal to the stacked run's {run['digest'] == stacked[engine, part_name][0]}, "
                f"lanes equal to [walk]'s {run['lanes_digest'] == walk_lanes[engine]}")
            if run["digest"] != stacked[engine, part_name][0] or \
                    run["lanes_digest"] != walk_lanes[engine]:
                raise AssertionError(f"[spmd] rank {rank} {engine}: the merged state differs "
                                     "from the stacked run's")
        if r["runs"]["local", "hash"]["msg_count"] == 0:
            raise AssertionError(f"[spmd] rank {rank}: no walker crossed under the hash "
                                 "partition")
        if r["spmd_batches"] != len(SPMD_RUNS) or r["backend"] != "gloo":
            raise AssertionError(f"[spmd] rank {rank}: {r['spmd_batches']} SPMD batches over "
                                 f"{r['backend']}")
        log(f"[spmd] rank {rank}: arrays loaded in {r['load_s']:.2f} s, SPMD batches "
            f"{r['spmd_batches']}")
    step = spmd_step_check(torch, np, counters, cfg, dev)
    log(f"[spmd] phase {time.perf_counter() - t0:.2f} s")
    return {"walk_ranks": out, "step": step}


# --- dynamic graphs: the refresh on fl-sim and on the reference's recipe --------

DURABLE_PLAN = {"round": [3], "tail": [1]}      # crash at a round and at a tail iteration
DURABLE_TORN = {"ckpt": [1]}                    # and leave the second snapshot torn
# Round or tail iterations a snapshot: 8 commit across the restarts. The
# torn write is the run's second, so a longer cadence loses more walked and
# trained work to it than its fewer writes save (PERF.md §5).
DURABLE_CKPT_EVERY = 3
DURABLE_KEEP = 2
DURABLE_CHECK_EVERY = 500       # global steps: the watchdog checks every tenth 50-step chunk
CHECK_TIMING_REPS = 7


def first_checked_step(start: int, total: int, per_call: int, chunk: int, every: int) -> int:
    """The global step at which the first chunk the watchdog checks ends,
    for a tail that trains from ``start``: calls of ``per_call`` steps in
    chunks of ``chunk``, a chunk checked when it crosses a multiple of
    ``every`` (``HealthMonitor.due``)."""
    step = start
    while step < total:
        n, done = min(per_call, total - step), 0
        while done < n:
            count = min(chunk, n - done)
            if step // every != (step + count) // every:
                return step + count
            step += count
            done += count
    raise AssertionError(f"no checked chunk between steps {start} and {total}")


def checked_chunk_ms(torch, np, pipe) -> tuple:
    """Device ms of one 50-step chunk of the pipeline's tail replayed
    unchecked and checked (the copy into the pre-chunk buffers, the same
    graph, the five reductions), in turns, by CUDA events; medians."""
    from repro_torch import prng
    from repro_torch.core.dsgl import build_alias_table, train_chunk_checked_in_place
    from repro_torch.data.pipeline import ring_chunk_indices
    from repro_torch.runtime.trainer import HEALTH_KEYS

    cfg, graphs = pipe.cfg, pipe._graphs
    table = build_alias_table(pipe.ring.ocn.cpu().numpy(), cfg.neg_power, pipe.device)
    idx = ring_chunk_indices(prng.fold_in(pipe.key_train, 12345), 0, pipe.ring.num_filled,
                             cfg.sync_period, pipe.num_shards, cfg.batch_groups,
                             cfg.multi_windows, pipe.device)
    args = (pipe.ring.walks[idx], table, prng.fold_in(pipe.key_train, 54321),
            np.full(cfg.sync_period, cfg.min_lr, np.float32), cfg.window, cfg.negatives)
    plain = lambda: graphs.train_chunk(pipe.phi_in, pipe.phi_out, *args)

    def checked():
        _, health = train_chunk_checked_in_place(graphs.train_chunk, pipe._pre_chunk(),
                                                 pipe.phi_in, pipe.phi_out, *args)
        return torch.stack([health[k].to(torch.float64) for k in HEALTH_KEYS])

    times = {"plain": [], "checked": []}
    for fn in (plain, checked):
        fn()
    torch.cuda.synchronize()
    for _ in range(CHECK_TIMING_REPS):
        for name, fn in (("plain", plain), ("checked", checked)):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    med = lambda v: sorted(v)[len(v) // 2]
    return med(times["plain"]), med(times["checked"])


def durable_phase(torch, np, counters, graph, assignment, want, dev) -> dict:
    """``[durable]``: the k = 2 yt-sim run of ``[main k=2]`` again, as a
    durable, supervised, watched run. The same pipeline (``PAPER_EMBED``,
    the graph's Cm counted first, that run's MPGP ``assignment``, two
    replicas) with a
    ``HealthMonitor`` checking every tenth chunk runs under
    ``run_with_restarts`` with a crash at a round, a torn snapshot and a
    crash at a tail iteration, snapshots every DURABLE_CKPT_EVERY
    iterations (DURABLE_KEEP kept) in a temporary directory, each crash
    resumed from the newest valid snapshot. phi must equal ``[main k=2]``'s
    (``want``) bit for bit; K1 launches = write-backs = the steps trained,
    replays included, every chunk a graph replay. Then the heal drill: the
    newest tail snapshot with steps left is resumed with a NaN injected into
    phi; the watchdog must report ``nonfinite`` at the first checked chunk,
    roll back to that snapshot (phi equal to its arrays bit for bit) and run
    to the end at lr scale 0.5: phi finite, the replica mean's AUC above
    0.75, one rollback. Telemetry is on with a flight directory: one flight
    record per fired fault, the counters printed, the run telemetry written
    and read back. Prints the restarts and faults, each snapshot's bytes and
    write seconds, each resume's seconds and the steps it replayed, the
    checked chunks and the device time a checked chunk adds."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.ckpt.checkpoint import load_checkpoint, read_meta, valid_steps
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core import dsgl
    from repro_torch.core.api import dsgl_config, make_walk_plan
    from repro_torch.eval import link_prediction_auc
    from repro_torch.kernels.sgns import ops
    from repro_torch.runtime.faults import FaultInjector, SimulatedFailure, run_with_restarts
    from repro_torch.runtime.health import HealthConfig, HealthMonitor
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    tag = "[durable]"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    root, flight = os.path.join(tmp, "ckpt"), os.path.join(tmp, "flight")
    try:
        t0 = time.perf_counter()
        graph = graph.with_edge_cm()
        torch.cuda.synchronize()
        log(f"{tag} Cm again in {time.perf_counter() - t0:.2f} s")
        policy, spec, rounds = make_walk_plan(PAPER_EMBED)
        cfg = dsgl_config(PAPER_EMBED)
        obs.reset()
        for name in counters:
            counters[name].LAUNCHES = 0
        ops.WRITEBACKS = 0
        dsgl.GRAPH_REPLAYS = 0
        with obs.override(enabled=True, flight_dir=flight):
            faults = FaultInjector(DURABLE_PLAN, torn_plan=DURABLE_TORN)
            health = HealthMonitor(HealthConfig(check_every=DURABLE_CHECK_EVERY))
            pipe = {"p": StreamingEmbedPipeline(graph, policy, spec, rounds, cfg,
                                                assignment=assignment, num_shards=2,
                                                health=health)}
            done = []                # (steps, chunks, checked chunks, snapshots) of each pipeline
            resumes = []
            retire = lambda q: done.append((q.steps_run, q.chunks, q.checked_chunks,
                                            q.snapshot_log))

            def attempt(i):
                q = pipe["p"]
                try:
                    return q.run(ckpt_root=root, ckpt_every_rounds=DURABLE_CKPT_EVERY,
                                 ckpt_keep=DURABLE_KEEP, faults=faults)
                except SimulatedFailure as err:
                    log(f"{tag} attempt {i} crashed at global step {q.global_step} "
                        f"(phase {q._phase}): {err}")
                    resumes.append({"crashed_at": q.global_step})
                    retire(q)
                    raise

            def recover(i):
                t = time.perf_counter()
                pipe["p"] = q = StreamingEmbedPipeline.resume(root, policy, spec, cfg,
                                                              health=health, device=dev)
                torch.cuda.synchronize()
                resumes[-1].update(s=time.perf_counter() - t, step=q.global_step,
                                   phase=q._phase,
                                   replays=resumes[-1]["crashed_at"] - q.global_step)

            t0 = time.perf_counter()
            res, restarts = run_with_restarts(attempt, recover=recover)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, writebacks, replays = ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS
            others = {name: c.LAUNCHES for name, c in counters.items() if name != "sgns_lifetime"}
            p = pipe["p"]
            retire(p)
            steps, chunks, checked = (sum(d[i] for d in done) for i in range(3))
            log(f"{tag} supervised run {wall:.2f} s: {restarts} restarts, faults fired "
                f"{faults.fired}, torn snapshot writes planned {DURABLE_TORN}; rounds "
                f"{res['rounds']}, final step {res['steps']}")
            for snap in (snap for d in done for snap in d[3]):
                log(f"{tag} snapshot {snap['seq']} ({snap['phase']}, step {snap['step']}): "
                    f"{snap['bytes']} bytes written in {snap['write_s']:.3f} s "
                    f"({snap['bytes'] / snap['write_s'] / 2**30:.3f} GiB/s)")
            for r in resumes:
                log(f"{tag} crash at step {r['crashed_at']}, resumed to step {r['step']} "
                    f"({r['phase']}) in {r['s']:.3f} s; {r['replays']} steps trained again")
            rep = health.report()
            log(f"{tag} K1 launches {launches}, write-backs {writebacks}, graph replays "
                f"{replays}; steps trained {steps} (the run's {res['steps']} and "
                f"{steps - res['steps']} again) in {chunks} chunks; checked chunks {checked} "
                f"({rep['checks']} checks, {rep['detections']} detections); other kernels "
                f"{others}")
            if restarts != 3 or sorted(faults.fired) != [("round", 3), ("tail", 1)] \
                    or faults.pending:
                raise AssertionError(f"{restarts} restarts, fired {faults.fired}, "
                                     f"{faults.pending} planned faults left")
            if launches != steps or writebacks != steps or replays != chunks:
                raise AssertionError(f"K1 launches {launches}, write-backs {writebacks} for "
                                     f"{steps} steps; {replays} replays for {chunks} chunks")
            got_in, got_out = (t.cpu() for t in p.embeddings())
            if not (torch.equal(got_in, want[0]) and torch.equal(got_out, want[1])):
                raise AssertionError("the crashed and resumed run's phi is not [main k=2]'s")
            log(f"{tag} phi equals [main k=2]'s bit for bit")
            records = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
            fault_records = [r for r in records if r.startswith("flight_fault_")]
            log(f"{tag} flight records {records}")
            if len(fault_records) != len(faults.fired):
                raise AssertionError(f"{len(fault_records)} flight records for "
                                     f"{len(faults.fired)} fired faults")
            counts = ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS
            plain_ms, checked_ms = checked_chunk_ms(torch, np, p)
            ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS = counts   # timing, not the path
            del p, pipe["p"]
            log(f"{tag} a 50-step chunk: {plain_ms:.4f} ms unchecked, {checked_ms:.4f} ms "
                f"checked: +{checked_ms - plain_ms:.4f} ms of device time a checked chunk")

            # The heal drill, from the newest tail snapshot with steps left.
            metas = {s: read_meta(root, s)[1] for s in valid_steps(root)}
            tail = max(s for s, m in metas.items()
                       if m["phase"] == "tail" and m["global_step"] < m["total_steps"])
            heal_root = os.path.join(tmp, "heal")
            os.makedirs(heal_root)
            os.rename(os.path.join(root, f"step_{tail:08d}"),
                      os.path.join(heal_root, f"step_{tail:08d}"))
            shutil.rmtree(root)
            _, snap, meta = load_checkpoint(heal_root, only=("phi_in", "phi_out"))
            heal_health = HealthMonitor(HealthConfig(check_every=DURABLE_CHECK_EVERY))
            t0 = time.perf_counter()
            q = StreamingEmbedPipeline.resume(heal_root, policy, spec, cfg, health=heal_health,
                                              device=dev)
            restored = []
            restore = q._restore_in_place

            def checked_restore():
                step = restore()
                restored.append(np.array_equal(q.phi_in.cpu().numpy(), snap["phi_in"])
                                and np.array_equal(q.phi_out.cpu().numpy(), snap["phi_out"]))
                return step

            q._restore_in_place = checked_restore
            want_step = first_checked_step(q.global_step, q.total_steps, q.steps_per_round,
                                           cfg.sync_period, DURABLE_CHECK_EVERY)
            heal_faults = FaultInjector(inject_plan={"phi_nan": [0]})
            heal = q.run(ckpt_root=heal_root, faults=heal_faults)
            torch.cuda.synchronize()
            heal_wall = time.perf_counter() - t0
            hrep = heal["health"]
            phi_in, phi_out = q.embeddings()
            finite = bool(torch.isfinite(phi_in).all() and torch.isfinite(phi_out).all())
            auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0)) if finite \
                else float("nan")
            detected = heal_health.detections[0].step if heal_health.detections else None
            log(f"{tag} heal drill from snapshot {tail} (step {meta['global_step']} of "
                f"{meta['total_steps']}) in {heal_wall:.2f} s: injected {heal_faults.injected}, "
                f"detections {hrep['detection_kinds']} at step {detected} (first checked "
                f"chunk ends at {want_step}), rollbacks {hrep['rollbacks']}, restored phi "
                f"equal to the snapshot {restored}, lr scale {heal['lr_scale']}, phi finite "
                f"{finite}, AUC {auc:.6f}; K1 launches now {ops.LAUNCHES}")
            if hrep["detection_kinds"] != ["nonfinite"] or detected != want_step \
                    or restored != [True] or hrep["rollbacks"] != 1 \
                    or heal["lr_scale"] != 0.5 or not finite or not auc > 0.75:
                raise AssertionError("the heal drill failed (line above)")
            steps, chunks = steps + q.steps_run, chunks + q.chunks
            launches, writebacks, replays = ops.LAUNCHES, ops.WRITEBACKS, dsgl.GRAPH_REPLAYS
            if launches != steps or writebacks != steps or replays != chunks:
                raise AssertionError(f"K1 launches {launches}, write-backs {writebacks} for "
                                     f"{steps} steps; {replays} replays for {chunks} chunks")

            snap_doc = obs.REGISTRY.snapshot()
            shown = {k: v for k, v in sorted(snap_doc["counters"].items())
                     if k.split(".")[0] in ("ckpt", "faults", "pipeline", "train", "walk",
                                            "health", "supervisor")}
            log(f"{tag} counters {shown}")
            log(f"{tag} gauges {dict(sorted(snap_doc['gauges'].items()))}")
            path = os.path.join(tmp, "RUN_TELEMETRY.json")
            obs.write_run_telemetry(path, run={"phase": "durable", "nodes": graph.num_nodes})
            doc = obs.load_run_telemetry(path)
            if doc["counters"] != snap_doc["counters"] \
                    or doc["counters"]["ckpt.resumes"] != len(resumes) + 2 \
                    or doc["counters"]["faults.torn.ckpt"] != 1 \
                    or doc["counters"]["pipeline.heals"] != 1 \
                    or doc["counters"]["train.steps"] != steps:
                raise AssertionError(f"run telemetry {doc['counters']}")
            log(f"{tag} run telemetry written and read back ({os.path.getsize(path)} bytes)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        obs.reset()
    log(f"{tag} phase {time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "writebacks": writebacks, "replays": replays,
            "checked_extra_ms": checked_ms - plain_ms}


REFRESH_CHURN = 0.05            # the reference's acceptance recipe: 5% churn, seed 1
REFRESH_MAX_AFFECTED = 0.30
REFRESH_AUC_GAP = 0.02


def affected_on_host(np, walks, roots, batch, n) -> np.ndarray:
    """The affected mask recounted on the host from the pre-update ring
    rows and their roots, in int64 numpy: the churn's endpoints, and every
    root whose walk steps along a changed arc in either direction."""
    changed = np.concatenate([batch.insert, batch.delete]).astype(np.int64)
    aff = np.zeros(n, bool)
    aff[np.unique(changed)] = True
    codes = np.unique(np.concatenate([changed[:, 0] * n + changed[:, 1],
                                      changed[:, 1] * n + changed[:, 0]]))
    for lo in range(0, len(walks), 1 << 16):
        w = walks[lo:lo + (1 << 16)].astype(np.int64)
        a, b = w[:, :-1], w[:, 1:]
        pair = np.maximum(a, 0) * n + np.maximum(b, 0)
        pos = np.minimum(np.searchsorted(codes, pair), len(codes) - 1)
        hit = ((codes[pos] == pair) & (a >= 0) & (b >= 0)).any(axis=1)
        aff[roots[lo:lo + (1 << 16)][hit]] = True
    return aff


# --- host preparation in a worker process -------------------------------------
# Graph generation, MPGP partitions and churn batches are numpy / Python on
# the host and need no card: a worker process makes them while the main
# process keeps the card busy, and hands over the arrays.


def host_graph(name: str, churn: bool = False) -> dict:
    """A preset's R-MAT graph as host arrays (``rmat_graph`` builds it with
    numpy, so these are the arrays the card's graph holds) and, with
    ``churn``, its 5% ``churn_batch`` (seed 1); with the seconds each took."""
    from repro_torch.configs.distger import GRAPH_PRESETS
    from repro_torch.graph.generators import churn_batch, rmat_graph

    preset = GRAPH_PRESETS[name]
    t0 = time.perf_counter()
    g = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0, device="cpu")
    out = {"indptr": g.indptr.numpy(), "indices": g.indices.numpy(),
           "graph_s": time.perf_counter() - t0}
    if churn:
        t0 = time.perf_counter()
        out["batch"] = churn_batch(g, REFRESH_CHURN, seed=1)
        out["churn_s"] = time.perf_counter() - t0
    return out


def host_mpgp(indptr, indices, edge_cm, k: int) -> tuple:
    """MPGP's k-way partition of the graph given as host arrays (with its
    Cm, which PS2 reads), and its seconds."""
    import torch

    from repro_torch.core.mpgp import mpgp_partition
    from repro_torch.graph.csr import CSRGraph

    g = CSRGraph(indptr=torch.from_numpy(indptr), indices=torch.from_numpy(indices),
                 edge_cm=torch.from_numpy(edge_cm))
    t0 = time.perf_counter()
    return mpgp_partition(g, k).assignment, time.perf_counter() - t0


def device_graph(torch, arrays: dict, dev):
    from repro_torch.graph.csr import CSRGraph

    return CSRGraph(indptr=torch.from_numpy(arrays["indptr"]).to(dev),
                    indices=torch.from_numpy(arrays["indices"]).to(dev))


def refresh_phase(torch, np, counters, dev, flsim: dict) -> dict:
    """Dynamic graphs, in two cases run through ``refresh_case``: fl-sim
    (80,513 nodes at degree 146; 16 rounds fit the ring) under
    ``PAPER_EMBED``, and the reference's acceptance recipe (rmat 2,048 at
    degree 10, seed 3, its test's ``EmbedConfig``). The recipe alone is held
    to the reference's acceptance, at most 30% of the vertices walked again
    and the refreshed AUC within 0.02 of scratch's: on fl-sim the pool's
    arcs lie on most walks, and the AUC does not rank a trained embedding
    of its R-MAT graph above chance (PERF.md §6), so there it is printed.
    On fl-sim the base run is also the oracle of ``[elastic]``, and the
    refresh is an ``IngestDriver`` drain (``[ingest fl-sim]``); the recipe's
    refresh is the oracle of the ingest drills (``[ingest recipe]``).
    ``flsim`` holds fl-sim's graph and churn, made by ``host_graph``."""
    from repro_torch.configs.distger import PAPER_EMBED
    from repro_torch.core.api import EmbedConfig
    from repro_torch.graph.generators import rmat_graph

    log(f"[refresh fl-sim] graph ({flsim['graph_s']:.2f} s) and churn_batch "
        f"({flsim['churn_s']:.2f} s) made on the host in a worker process")
    runs = [refresh_case(torch, np, counters, dev, "fl-sim", device_graph(torch, flsim, dev),
                         PAPER_EMBED, elastic=True, ingest=True,
                         churn=(flsim["batch"], flsim["churn_s"]))]
    torch.cuda.empty_cache()
    runs.append(refresh_case(torch, np, counters, dev, "recipe",
                             rmat_graph(2048, 10, seed=3, device=dev),
                             EmbedConfig(dim=32, epochs=1, lr=0.05, delta=1e-3, max_len=40,
                                         min_len=10, window=6, negatives=4),
                             acceptance=True, drills=True))
    return {"launches": {k: v for run in runs for k, v in run["launches"].items()},
            "writebacks": sum(run["writebacks"] for run in runs),
            "replays": sum(run["replays"] for run in runs),
            "serve_launches": sum(run["serve_launches"] for run in runs)}


def refresh_case(torch, np, counters, dev, name: str, graph, cfg, acceptance=False,
                 elastic=False, ingest=False, drills=False, churn=None) -> dict:
    """``embed_graph(cfg, num_shards=2, return_state=True)`` on the graph, a
    5% ``churn_batch`` (seed 1) and ``refresh_embedding``, every launch count
    set to 0 before each and read after. Checks: every slot whose pre-update root
    is unaffected is bit-identical after the refresh; the affected mask
    equals a recount on the host; the first and the last retained round's
    spliced rows equal a full vertex-keyed round of every source on the
    mutated graph; ocn moved by exactly the tokens spliced and appended less
    those replaced; the overlay's graph holds exactly the arcs of the graph
    before less the deleted and plus the inserted edges, and its incremental
    Cm equals ``edge_common_neighbors`` of it; K1 launches = write-backs =
    fine-tune steps, all in graph replays, with a hotness sync at each
    50-step boundary; phi finite. With ``acceptance``, the reference's: at
    most 30% of the vertices walked again, and the refreshed AUC within 0.02
    of a from-scratch vertex-keyed ``embed_graph`` of the mutated graph's
    (run only then: on fl-sim no AUC ranks the graph's edges, PERF.md §6).

    With ``elastic``, ``elastic_case`` runs after the base run, against its
    ring and phi. With ``ingest`` the churn goes through
    ``IngestDriver.submit`` (``apply_every=1``): the drain is the refresh
    every check above holds, and then the WAL must be truncated with
    ``applied_seq == appended_seq == 1``, the snapshot's meta must carry
    ``applied_seq``, and ``IngestDriver.recover`` on the root must end with
    nothing pending and phi equal to the driven pipeline's. With ``drills``
    the refreshed pipeline is the oracle of ``ingest_drills``."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import prng
    from repro_torch.core import dsgl
    from repro_torch.core.api import embed_graph, refresh_embedding
    from repro_torch.core.walker import VertexKeys, run_walk_batch
    from repro_torch.eval import link_prediction_auc
    from repro_torch.graph.csr import edge_common_neighbors
    from repro_torch.ckpt.checkpoint import read_meta
    from repro_torch.graph.generators import churn_batch
    from repro_torch.runtime.ingest import IngestConfig, IngestDriver
    from repro_torch.runtime.serve import EmbedServer, ServeConfig

    reset = lambda: reset_counts(torch, counters)
    counts = lambda: read_counts(torch, counters)

    tag = f"[refresh {name}]"
    t_phase = time.perf_counter()
    n = graph.num_nodes
    log(f"{tag} |V|={n} arcs={graph.num_edges}; {cfg.method}, dim {cfg.dim}, max_len "
        f"{cfg.max_len}, window {cfg.window}, lr {cfg.lr}, epochs {cfg.epochs}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1. the base run ------------------------------------------------------------
    t0 = reset()
    phi0, _, base, state = embed_graph(graph, cfg, num_shards=2, return_stats=True,
                                       return_state=True, device=dev)
    base_wall = time.perf_counter() - t0
    base_n = counts()
    pipe = state.refresher.pipeline
    ws = base["stats"]
    log(f"{tag} base embed_graph wall {base_wall:.2f} s: Cm {base['cm_s']:.2f} s, "
        f"partition {base['part_s']:.2f} s, walks {ws['phase_s']['walk']:.2f} s, training "
        f"{ws['phase_s']['train']:.2f} s; rounds {base['rounds']} (ring {pipe.ring_rounds}), "
        f"supersteps {ws['supersteps']}, steps {base['steps']}, K1 launches {base_n['k1']}")
    if base_n["k1"] != base["steps"] or base_n["writebacks"] != base["steps"] \
            or base_n["replays"] != base["chunks"]:
        raise AssertionError(f"{tag} base run: {base_n} for {base['steps']} steps in "
                             f"{base['chunks']} chunks")
    log(f"{tag} base run's link-prediction AUC on the graph before the churn "
        f"{link_prediction_auc(graph, phi0, np.random.default_rng(7)):.6f}")
    walks_before = pipe.ring.walks.clone()
    lengths_before = pipe.ring.lengths.clone()
    ocn_before = pipe.ring.ocn.clone()
    roots_before = pipe._slot_root.copy()
    rounds_before = pipe._slot_round.copy()
    extra = {}                          # the launches of [elastic] and the ingest drills
    if elastic:
        extra["elastic"] = elastic_case(torch, np, counters, dev, pipe,
                                        (walks_before, lengths_before, ocn_before,
                                         pipe.phi_in.clone(), pipe.phi_out.clone()))
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_ingest_{name}_")
    pre_root = os.path.join(tmp, "pre_churn")
    if drills:                          # the drills start from the state before the churn
        pipe.save(pre_root)

    # 2. the churn (host numpy; ``churn`` when a worker process made it) ------------
    t0 = time.perf_counter()
    batch, churn_s = churn if churn is not None else (
        churn_batch(graph, REFRESH_CHURN, seed=1), None)
    churn_s = time.perf_counter() - t0 if churn_s is None else churn_s
    log(f"{tag} churn_batch: +{len(batch.insert)} / -{len(batch.delete)} edges "
        f"({batch.num_changes / (graph.num_edges / 2):.6f} of the edges) in {churn_s:.2f} s "
        f"on the host{' (a worker process)' if churn is not None else ''}")

    # 3. the refresh: refresh_embedding, or a drain of the ingest driver -------------
    drv, serve_launches = None, 0
    if ingest:
        t0 = time.perf_counter()
        server = EmbedServer(ServeConfig(), device=dev)
        drv = IngestDriver(os.path.join(tmp, "ingest"), pipe, cfg=IngestConfig(apply_every=1),
                           server=server)
        snap0 = pipe.snapshot_log[-1]
        log(f"[ingest {name}] the driver's first snapshot: {snap0['bytes']} bytes in "
            f"{snap0['write_s']:.3f} s ({time.perf_counter() - t0:.2f} s with the IngestDriver and "
            f"its offer to an EmbedServer on the card)")
        v_pre, serve_launches = serve_ingest(torch, np, counters, server, "before the submit",
                                             402, dev)
    g_step0, chunks0, syncs0 = pipe.global_step, pipe.chunks, pipe.syncs
    batches0 = len(pipe.batch_supersteps)
    torch.cuda.reset_peak_memory_stats()
    t0 = reset()
    if ingest:
        drv.submit(batch)
        rs = drv.refresher.last_stats
        phi1 = pipe.embeddings()[0].clone()
        refresher = drv.refresher
    else:
        phi1, _, rs = refresh_embedding(state, batch)
        refresher = state.refresher
    refresh_wall = time.perf_counter() - t0
    ref_n = counts()
    refresh_peak = torch.cuda.max_memory_allocated() / 2**30
    g2 = pipe.graph
    ph = rs.phase_s
    if ingest:
        ingest_checks(torch, np, name, drv, pipe, refresh_wall, dev)
        v_post, n_post = serve_ingest(torch, np, counters, server, "after the drain", 403, dev)
        serve_launches += n_post
        published = read_meta(drv.ckpt_dir)[0]
        st = server.stats()
        log(f"[ingest {name}] the server: version {v_pre} before the submit, {v_post} after "
            f"the drain (the IngestDriver's newest snapshot {published}); swaps {st['swaps']}, "
            f"availability {st['availability']}, freshness {st['freshness']}")
        if not (v_pre < v_post == published and st["availability"] == 1.0
                and st["swaps"] == 2 and st["freshness"] == "fresh"):
            raise AssertionError(f"[ingest {name}] the server did not move to the drain's "
                                 f"snapshot: {v_pre} -> {v_post}, newest {published}, {st}")
    log(f"{tag} affected {rs.affected} ({rs.affected_frac:.6f} of |V|), retained rounds "
        f"{rs.retained_rounds}, extra rounds {rs.extra_rounds}, re-walked walks "
        f"{rs.rewalk_walks}, re-walk supersteps {rs.rewalk_supersteps} (the base run's "
        f"{ws['supersteps']}), fine-tune steps {rs.fine_tune_steps}")
    log(f"{tag} refresh_embedding wall {refresh_wall:.2f} s: compact {ph['compact']:.2f} s "
        f"(Cm {ph['cm']:.2f} s), detection {ph['detect']:.2f} s, re-walk {ph['rewalk']:.2f} s, "
        f"top-up {ph['topup']:.2f} s, fine-tune {ph['finetune']:.2f} s; base embed "
        f"{base_wall:.2f} s; peak device memory {refresh_peak:.3f} GiB")
    want_steps = rs.fine_tune_steps
    want_syncs = pipe.global_step // dsgl.DSGLConfig().sync_period \
        - g_step0 // dsgl.DSGLConfig().sync_period
    log(f"{tag} K1 launches {ref_n['k1']}, write-backs {ref_n['writebacks']}, graph replays "
        f"{ref_n['replays']} for {pipe.chunks - chunks0} chunks, hotness syncs "
        f"{pipe.syncs - syncs0} (50-step boundaries {want_syncs}), walk batches on the sharded "
        f"engine {ref_n['batches']} of {len(pipe.batch_supersteps) - batches0}, other kernels "
        f"{ref_n['others']}")
    if ref_n["k1"] != want_steps or ref_n["writebacks"] != want_steps \
            or ref_n["replays"] != pipe.chunks - chunks0 or pipe.syncs - syncs0 != want_syncs \
            or pipe.global_step - g_step0 != want_steps:
        raise AssertionError(f"{tag} every fine-tune step must be a K1 launch in a graph "
                             f"replay: {ref_n}, {pipe.syncs - syncs0} syncs")
    if ref_n["batches"] != len(pipe.batch_supersteps) - batches0 or any(ref_n["others"].values()):
        raise AssertionError(f"{tag} walk batches or other kernels: {ref_n}")
    if not (torch.isfinite(phi1).all() and torch.isfinite(pipe.phi_out).all()):
        raise AssertionError(f"{tag} phi is not finite")

    # Unaffected slots bit-identical; the mask against a recount on the host.
    t0 = time.perf_counter()
    aff = refresher.last_affected_mask
    written = roots_before >= 0
    host_aff = affected_on_host(np, walks_before.cpu().numpy()[written], roots_before[written],
                                batch, n)
    if not np.array_equal(host_aff, aff):
        raise AssertionError(f"{tag} affected mask {int(aff.sum())} != the host's "
                             f"{int(host_aff.sum())}")
    kept = torch.from_numpy(np.nonzero(written & ~aff[np.maximum(roots_before, 0)])[0]).to(dev)
    same_kept = torch.equal(walks_before[kept], pipe.ring.walks[kept]) and \
        torch.equal(lengths_before[kept], pipe.ring.lengths[kept])
    touched = np.unique(np.concatenate([batch.insert, batch.delete]))
    log(f"{tag} unaffected slots {len(kept)} bit-identical {same_kept}; affected mask equals "
        f"the host's int64 recount True: {len(touched)} churn endpoints, "
        f"{int(aff.sum()) - len(touched)} more roots whose walks traverse a changed arc")
    if not same_kept:
        raise AssertionError(f"{tag} a slot of an unaffected root changed")

    # ocn moved by exactly the tokens of the slots written less those they held.
    now_roots = pipe._slot_root
    moved = np.nonzero((now_roots >= 0) & (~written | aff[np.maximum(roots_before, 0)]))[0]
    moved_t = torch.from_numpy(moved).to(dev)
    tokens = lambda w: torch.bincount(w[w >= 0].to(torch.int64), minlength=n)
    want_ocn = tokens(pipe.ring.walks[moved_t]) - tokens(walks_before[moved_t])
    ocn_ok = torch.equal(pipe.ring.ocn.to(torch.int64) - ocn_before.to(torch.int64), want_ocn)
    log(f"{tag} ocn after - before == tokens written - tokens replaced over {len(moved)} "
        f"slots: {ocn_ok}")
    if not ocn_ok:
        raise AssertionError(f"{tag} ocn is not exact after the refresh")

    # The first and the last retained round's spliced rows against full rounds.
    resident = np.unique(rounds_before[written & aff[np.maximum(roots_before, 0)]])
    spliced = {}
    for r in sorted({int(resident[0]), int(resident[-1])}):
        t1 = time.perf_counter()
        sources = torch.arange(n, device=dev)
        full = run_walk_batch(g2, sources, VertexKeys(prng.fold_in(pipe.key_walk, r), sources),
                              pipe.policy, pipe.spec, pipe.assignment,
                              num_shards=pipe.walk_shards)
        sel = np.nonzero(written & aff[np.maximum(roots_before, 0)] & (rounds_before == r))[0]
        rows = torch.from_numpy(roots_before[sel]).to(dev)
        slots = torch.from_numpy(sel).to(dev)
        spliced[r] = (len(sel), torch.equal(pipe.ring.walks[slots], full.path[rows])
                      and torch.equal(pipe.ring.lengths[slots], full.info.L.to(torch.int32)[rows]))
        log(f"{tag} round {r}: {len(sel)} spliced rows equal a full vertex-keyed round of "
            f"{n} sources on the mutated graph {spliced[r][1]} ({time.perf_counter() - t1:.2f} s)")
        del full
    if not all(ok for _, ok in spliced.values()):
        raise AssertionError(f"{tag} spliced rows differ from full rounds: {spliced}")

    # The overlay's graph against the edge set the churn makes, arc for arc.
    def arc_codes(g):
        rows = torch.repeat_interleave(torch.arange(n, device=dev), g.degrees(),
                                       output_size=g.num_edges)
        return rows, rows * n + g.indices.to(torch.int64)

    def both_ways(edges):
        e = torch.from_numpy(edges).to(dev)
        return torch.cat([e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]])

    old = arc_codes(graph)[1]
    want = torch.sort(torch.cat([old[~torch.isin(old, both_ways(batch.delete))],
                                 both_ways(batch.insert)])).values
    src, got = arc_codes(g2)
    arcs_ok = torch.equal(got, want) and g2.weights is None
    log(f"{tag} the overlay's graph: {g2.num_edges} arcs = {graph.num_edges} - "
        f"{2 * len(batch.delete)} + {2 * len(batch.insert)}, the mutated edge set: {arcs_ok}")
    if not arcs_ok:
        raise AssertionError(f"{tag} the overlay's graph is not the mutated edge set")
    del old, want, got

    # The overlay's incremental Cm against a full recount.
    mark = torch.zeros(n, dtype=torch.bool, device=dev)
    mark[torch.from_numpy(touched).to(dev)] = True
    deg = g2.degrees()
    stale = mark[src] | mark[g2.indices]
    wedges = torch.minimum(deg[src], deg[g2.indices])
    log(f"{tag} Cm: {int(stale.sum())} of {g2.num_edges} arcs recounted (a touched "
        f"endpoint), {int(wedges[stale].sum())} of {int(wedges.sum())} wedges")
    del src, stale, wedges
    t1 = time.perf_counter()
    full_cm = edge_common_neighbors(g2)
    torch.cuda.synchronize()
    cm_ok = torch.equal(g2.edge_cm, full_cm)
    log(f"{tag} incremental Cm ({ph['cm']:.2f} s) equals edge_common_neighbors of the "
        f"mutated graph ({time.perf_counter() - t1:.2f} s): {cm_ok}")
    if not cm_ok:
        raise AssertionError(f"{tag} the incremental Cm differs from the full recount")
    del full_cm, walks_before, lengths_before
    log(f"{tag} checks {time.perf_counter() - t0:.2f} s")

    # 4. the AUCs; from scratch on the mutated graph where the acceptance needs it
    phis = {"stale": phi0, "refreshed": phi1}
    runs = {"embed k=2": base_n, "ingest drain" if ingest else "refresh": ref_n}
    if acceptance:
        torch.cuda.empty_cache()
        t0 = reset()
        phis["scratch"], _, scratch = embed_graph(
            g2, dataclasses.replace(cfg, rng_mode="vertex"), num_shards=2, return_stats=True,
            device=dev)
        scratch_wall = time.perf_counter() - t0
        runs["scratch k=2"] = counts()
        log(f"{tag} scratch embed_graph wall {scratch_wall:.2f} s (rounds {scratch['rounds']}, "
            f"K1 launches {runs['scratch k=2']['k1']}); refresh / scratch wall "
            f"{refresh_wall / scratch_wall:.4f}")
    auc = {which: link_prediction_auc(g2, phi, np.random.default_rng(7))
           for which, phi in phis.items()}
    log(f"{tag} refresh / base wall {refresh_wall / base_wall:.4f}; link-prediction AUC on the "
        "mutated graph: "
        + ", ".join(f"{which} {v:.6f}" for which, v in auc.items()))
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"phase {time.perf_counter() - t_phase:.2f} s")
    if drills:
        extra.update(ingest_drills(torch, np, counters, dev, pipe, batch, pre_root, tmp))
    shutil.rmtree(tmp, ignore_errors=True)
    if acceptance and (rs.affected_frac > REFRESH_MAX_AFFECTED
                       or abs(auc["refreshed"] - auc["scratch"]) > REFRESH_AUC_GAP):
        raise AssertionError(f"{tag} the reference's acceptance: {rs.affected_frac} of the "
                             f"vertices walked again (at most {REFRESH_MAX_AFFECTED}), refreshed "
                             f"AUC {auc['refreshed']} against scratch's {auc['scratch']} (within "
                             f"{REFRESH_AUC_GAP})")
    runs.update(extra)
    return {"launches": {f"{name} {run}": n["k1"] for run, n in runs.items()},
            "writebacks": sum(n["writebacks"] for n in runs.values()),
            "replays": sum(n["replays"] for n in runs.values()),
            "serve_launches": serve_launches}


def reset_counts(torch, counters) -> float:
    """Every launch count to 0, the device drained; returns the host clock."""
    from repro_torch.core import dsgl, shard_engine
    from repro_torch.kernels.sgns import ops

    torch.cuda.synchronize()
    for c in counters.values():
        c.LAUNCHES = 0
    ops.WRITEBACKS = 0
    dsgl.GRAPH_REPLAYS = 0
    shard_engine.BATCHES = 0
    return time.perf_counter()


def read_counts(torch, counters) -> dict:
    from repro_torch.core import dsgl, shard_engine
    from repro_torch.kernels.sgns import ops

    torch.cuda.synchronize()
    return {"k1": ops.LAUNCHES, "writebacks": ops.WRITEBACKS, "replays": dsgl.GRAPH_REPLAYS,
            "batches": shard_engine.BATCHES,
            "others": {n: c.LAUNCHES for n, c in counters.items() if n != "sgns_lifetime"}}


def check_k1(tag: str, n: dict, steps: int, chunks: int) -> None:
    """K1 launches = write-backs = the steps trained, every chunk a graph
    replay, and no other kernel launched."""
    log(f"{tag} K1 launches {n['k1']}, write-backs {n['writebacks']}, graph replays "
        f"{n['replays']} for {steps} steps in {chunks} chunks; walk batches on the sharded "
        f"engine {n['batches']}; other kernels {n['others']}")
    if n["k1"] != steps or n["writebacks"] != steps or n["replays"] != chunks \
            or any(n["others"].values()):
        raise AssertionError(f"{tag} every step must be a K1 launch in a graph replay: {n}, "
                             f"{steps} steps in {chunks} chunks")


#: ``[elastic]``'s outage: walk shard 1 misses the probe of round 1 and
#: answers from round 2 on (misses_to_dead = hits_to_live = 1): k = 2 -> 1
#: at round 1 (round 2 walks at k = 1), back to 2 at round 2.
ELASTIC_DOWN = {1: (1, 2)}
#: No cadence snapshot: one after each reconfiguration, and the final one.
ELASTIC_CKPT_EVERY = 10**6


def elastic_case(torch, np, counters, dev, base, oracle) -> dict:
    """``[elastic]``: fl-sim's base run (``base``, ``PAPER_EMBED`` with vertex
    keys at k = 2 under MPGP) again, on the same graph, Cm, partition and
    config, with a ``LivenessProbe`` and an outage of walk shard 1
    (ELASTIC_DOWN): one death (its nodes streamed into shard 0, its
    resident walks walked again) and one re-join (a donor region streamed
    into the returned shard), each followed by a snapshot; the death builds
    the k = 1 partition-local store and the re-join rebuilds it through
    ``reassign_partitioned_csr``. Checks: one death and one
    re-join, k = 2 at the end; ring (walks, lengths, ocn) and phi equal
    the base run's (``oracle``, copied before its refresh) bit for bit;
    the snapshot after the re-join resumes at k = 2 with that moment's
    assignment and phi; K1 launches = write-backs = the steps trained, in
    graph replays. Right after that snapshot (a hook), every ring slot
    rooted in the new shard 1 is zeroed through ``ring_replace`` and
    ``recover_shard_loss(1)`` must restore ring and ocn bit for bit; the run
    then goes on from the restored ring, so its end-state equality covers
    the recovery too. (It runs there, on the 3 rounds walked by then, and
    not on the finished run's 9: a re-walk costs its rounds' supersteps,
    ~46-68 s for 9 on fl-sim.) Prints the seconds of the reassign, the
    re-join, each partition rebuild, the orphans' re-walk and the recovery,
    the moved roots, the slices reused and the snapshots' bytes and
    seconds."""
    import shutil
    import tempfile

    from repro_torch.core import shard_engine
    from repro_torch.core.corpus import ring_replace
    from repro_torch.runtime.faults import FaultInjector, LivenessProbe
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    tag = "[elastic]"
    t_phase = time.perf_counter()
    walks0, lengths0, ocn0, phi_in0, phi_out0 = oracle
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        log(f"{tag} fl-sim, the base run's graph, partition and config; outage {ELASTIC_DOWN}")
        p = StreamingEmbedPipeline(base.graph, base.policy, base.spec, base._rounds_cfg,
                                   base.cfg, assignment=base.assignment, num_shards=2)
        seen = {}

        def recover_check():
            """Zero shard 1's resident slots, recover them, compare."""
            ring = p.ring
            before = (ring.walks.clone(), ring.lengths.clone(), ring.ocn.clone())
            lost = np.asarray(p.assignment) == 1
            bad = np.nonzero((p._slot_root >= 0) & lost[np.maximum(p._slot_root, 0)])[0]
            ring_replace(ring, torch.from_numpy(bad).to(dev),
                         torch.zeros(len(bad), ring.walks.shape[1], dtype=ring.walks.dtype,
                                     device=dev),
                         torch.ones(len(bad), dtype=torch.int32, device=dev))
            damaged = not torch.equal(ring.walks, before[0])
            info = p.recover_shard_loss(1)
            restored = all(torch.equal(a, b) for a, b in
                           zip((ring.walks, ring.lengths, ring.ocn), before))
            return dict(info, zeroed=len(bad), damaged=damaged, restored=restored)

        def hook(path, seq, meta):      # the state the snapshot after the re-join holds
            if meta["walk_shards"] == 1:
                seen.setdefault("death", seq)
            elif "death" in seen and "rejoin" not in seen:
                seen["rejoin"] = (seq, p.phi_in.clone(), p.phi_out.clone(), p.assignment.copy())
                seen["recover"] = recover_check()

        p.add_snapshot_hook(hook)
        t0 = reset_counts(torch, counters)
        res = p.run(ckpt_root=tmp, ckpt_every_rounds=ELASTIC_CKPT_EVERY,
                    faults=FaultInjector(down_plan=ELASTIC_DOWN),
                    liveness=LivenessProbe(num_shards=2, misses_to_dead=1, hits_to_live=1))
        wall = time.perf_counter() - t0
        n = read_counts(torch, counters)
        recs = res["reconfigs"]
        kinds = [r.get("kind", "death") for r in recs]
        ws = res["stats"]
        log(f"{tag} run wall {wall:.2f} s (the recovery's {seen['recover']['wall_s']:.2f} s "
            f"included): walks {ws['phase_s']['walk']:.2f} s, training "
            f"{ws['phase_s']['train']:.2f} s; rounds {res['rounds']}, steps {res['steps']}; "
            f"reconfigurations {kinds}, walk shards at the end {p.walk_shards}")
        for r in recs:
            ph = r["phase_s"]
            if r.get("kind") == "rejoin":
                log(f"{tag} re-join to k = {r['walk_shards']}: rejoin_shard {ph['rejoin']:.3f} s "
                    f"({r['moved_roots']} donor roots, {r['moved_frac']:.6f} of |V|), partition "
                    f"rebuild {ph['partitions']:.3f} s ({r['reused_shards']} slices reused, "
                    f"{r['rebuilt_shards']} rebuilt); {r['wall_s']:.3f} s in all")
            else:
                log(f"{tag} death of shard {r['dead_shard']} (launch id {r['launch_id']}) to "
                    f"k = {r['walk_shards']}: reassign_dead_shard {ph['reassign']:.3f} s "
                    f"({r['moved_roots']} orphan roots, {r['moved_frac']:.6f} of |V|), partition "
                    f"rebuild {ph['partitions']:.3f} s ({r['reused_shards']} slices reused, "
                    f"{r['rebuilt_shards']} rebuilt), the orphans' re-walk {ph['rewalk']:.3f} s "
                    f"({r['rewalk_walks']} walks over {r['rounds_resident']} resident rounds); "
                    f"{r['wall_s']:.3f} s in all")
        for snap in p.snapshot_log:
            log(f"{tag} snapshot {snap['seq']} ({snap['phase']}, step {snap['step']}): "
                f"{snap['bytes']} bytes in {snap['write_s']:.3f} s")
        check_k1(tag, n, p.steps_run, p.chunks)
        if n["batches"] != len(p.batch_supersteps):
            raise AssertionError(f"{tag} {n['batches']} sharded batches of "
                                 f"{len(p.batch_supersteps)}")
        same_ring = torch.equal(p.ring.walks, walks0) and torch.equal(p.ring.lengths, lengths0) \
            and torch.equal(p.ring.ocn, ocn0)
        same_phi = torch.equal(p.phi_in, phi_in0) and torch.equal(p.phi_out, phi_out0)
        log(f"{tag} ring equals the base run's bit for bit {same_ring}; phi {same_phi}")
        if kinds != ["death", "rejoin"] or p.walk_shards != 2 or not (same_ring and same_phi):
            raise AssertionError(f"{tag} {kinds} at k = {p.walk_shards}: ring {same_ring}, "
                                 f"phi {same_phi}")

        seq, phi_i, phi_o, asn = seen["rejoin"]
        t0 = time.perf_counter()
        q = StreamingEmbedPipeline.resume(tmp, base.policy, base.spec, base.cfg, step=seq,
                                          device=dev)
        resumed = q.walk_shards == 2 and np.array_equal(q.assignment, asn) \
            and torch.equal(q.phi_in, phi_i) and torch.equal(q.phi_out, phi_o)
        log(f"{tag} the snapshot after the re-join ({seq}) resumed in "
            f"{time.perf_counter() - t0:.2f} s: walk shards {q.walk_shards}, its assignment and "
            f"phi bit for bit {resumed}")
        del q, phi_i, phi_o
        torch.cuda.empty_cache()
        if not resumed:
            raise AssertionError(f"{tag} the post-re-join snapshot resumed to another state")

        info = seen["recover"]
        log(f"{tag} recover_shard_loss(1) after the re-join's snapshot: {info['zeroed']} slots of "
            f"{info['lost_roots']} roots zeroed (damaged {info['damaged']}), "
            f"{info['rewalk_walks']} walks over {info['rounds_resident']} rounds walked again in "
            f"{info['wall_s']:.2f} s; ring and ocn restored bit for bit {info['restored']}")
        if not (info["damaged"] and info["restored"]):
            raise AssertionError(f"{tag} recover_shard_loss did not restore the ring")
        p._snapshot_hooks.clear()       # the hook refers to p: free the pipeline on return
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shard_engine._PCSR_CACHE.clear()
    log(f"{tag} phase {time.perf_counter() - t_phase:.2f} s")
    return n


def ingest_checks(torch, np, name, drv, pipe, submit_wall: float, dev) -> None:
    """After fl-sim's drain through the ingest driver: the WAL acknowledged
    and truncated, ``applied_seq == appended_seq == 1``, the snapshot's
    meta carrying ``applied_seq``; then ``IngestDriver.recover`` on the root
    alone must end with nothing pending and phi equal to the driven
    pipeline's bit for bit."""
    from repro_torch.ckpt.checkpoint import read_meta
    from repro_torch.runtime.ingest import IngestDriver

    tag = f"[ingest {name}]"
    st = drv.staleness()
    wal = drv.wal.last_append
    snap = pipe.snapshot_log[-1]
    meta = read_meta(drv.ckpt_dir)[1]
    truncated = drv.wal.replay() == ([], 0) and os.path.getsize(drv.wal.path) == 0
    rs = drv.refresher.last_stats
    log(f"{tag} WAL append {wal['bytes']} bytes: write {wal['write_s'] * 1e3:.3f} ms, fsync "
        f"{wal['fsync_s'] * 1e3:.3f} ms; drain mode {drv.last_mode}, refresh {rs.wall_s:.2f} s, "
        f"the drain's snapshot {snap['bytes']} bytes in {snap['write_s']:.3f} s; submit to "
        f"applied {submit_wall:.2f} s; applied_seq {st['applied_seq']}, appended_seq "
        f"{st['appended_seq']}, WAL truncated {truncated}, the snapshot's applied_seq "
        f"{meta.get('applied_seq')}")
    if not (st["applied_seq"] == st["appended_seq"] == 1 and st["pending_batches"] == 0
            and truncated and meta.get("applied_seq") == 1 and drv.last_mode == "full"):
        raise AssertionError(f"{tag} the drain's protocol: {st}, truncated {truncated}, "
                             f"meta {meta.get('applied_seq')}")
    t0 = time.perf_counter()
    rec = IngestDriver.recover(drv.root, pipe.policy, pipe.spec, pipe.cfg, device=dev)
    same = torch.equal(rec.pipeline.phi_in, pipe.phi_in) \
        and torch.equal(rec.pipeline.phi_out, pipe.phi_out)
    pending = rec.staleness()["pending_batches"]
    log(f"{tag} IngestDriver.recover from the root alone in {time.perf_counter() - t0:.2f} s: "
        f"applied_seq {rec.applied_seq}, pending {pending}, phi equals the driven pipeline's "
        f"bit for bit {same}")
    del rec
    torch.cuda.empty_cache()
    if not same or pending:
        raise AssertionError(f"{tag} the recovered driver differs")


def ingest_drills(torch, np, counters, dev, oracle, batch, pre_root, tmp) -> dict:
    """``[ingest recipe]``: the recipe's churn from its pre-churn snapshot
    through both drills in one refresh, held to the refreshed pipeline
    ``oracle`` (``refresh_embedding``'s result; the driver's defaults are
    its: the traversal detection and the refresh's own fine-tune steps) in
    phi, ring and ocn bit for bit. A driver is killed after a durable
    ``wal_append``; ``IngestDriver.recover`` rebuilds it from the disk
    alone, and its drain's first attempt dies at ``refresh_splice``, so it
    restores the snapshot in place and retries once, to land on the oracle.
    K1 launches = write-backs = the steps trained, in graph replays."""
    from repro_torch.runtime.faults import FaultInjector, SimulatedFailure
    from repro_torch.runtime.ingest import IngestConfig, IngestDriver
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    tag = "[ingest recipe]"
    t_phase = time.perf_counter()
    plan = (oracle.policy, oracle.spec, oracle.cfg)
    root = os.path.join(tmp, "crash")
    drv = IngestDriver(root, StreamingEmbedPipeline.resume(pre_root, *plan, device=dev),
                       cfg=IngestConfig(apply_every=1), faults=FaultInjector({"wal_append": [0]}))
    crashed = False
    try:
        drv.submit(batch)
    except SimulatedFailure:
        crashed = True
    durable = drv.appended_seq == 1 and drv.applied_seq == 0
    del drv
    torch.cuda.empty_cache()
    delays = []
    mem0 = torch.cuda.memory_allocated()
    t0 = reset_counts(torch, counters)
    rec = IngestDriver.recover(root, *plan, cfg=IngestConfig(apply_every=1, max_retries=1,
                                                             backoff_s=0.01),
                               faults=FaultInjector({"refresh_splice": [0]}),
                               sleep=delays.append, device=dev)
    wall = time.perf_counter() - t0
    n = read_counts(torch, counters)
    p = rec.pipeline
    same = torch.equal(p.phi_in, oracle.phi_in) and torch.equal(p.phi_out, oracle.phi_out) \
        and torch.equal(p.ring.walks, oracle.ring.walks) and torch.equal(p.ring.ocn, oracle.ring.ocn)
    ok = crashed and durable and rec.retries == 1 and delays == [0.01] \
        and rec.applied_seq == rec.appended_seq == 1 and same
    log(f"{tag} a driver killed after a durable wal_append (crashed {crashed}, the batch "
        f"durable {durable}) recovered from the disk alone; its drain died at "
        f"refresh_splice[0], restored the snapshot in place and retried {rec.retries} time(s): "
        f"{wall:.2f} s (mode {rec.last_mode}), device memory "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**20:+.1f} MiB (the recovered pipeline); "
        f"phi, ring and ocn equal refresh_embedding's bit for bit {same}")
    check_k1(tag, n, p.steps_run, p.chunks)
    del rec, p
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{tag} the recovered, retried drain differs from "
                             "refresh_embedding's")
    log(f"{tag} drills {time.perf_counter() - t_phase:.2f} s")
    return {"ingest recover + retry": n}


# --- flash attention (K2) ---------------------------------------------------

# --- embedding serving: the order-pinned scoring kernel (chain_dot) ------------------------

#: The kernel's cases held against ``ref.py`` on the card: every d it must
#: take (below, at and above a float4 step, a 128-column chunk and its ragged
#: successor), ragged batches, and through a server on the card candidate
#: widths 0-1,024 (padded to powers of two) and k up to N.
SERVE_DIMS = (1, 7, 16, 17, 64, 128, 129)
SERVE_BATCHES = (1, 5, 32, 40)
SERVE_WIDTHS = (0, 1, 2, 3, 5, 31, 32, 33, 100, 511, 512, 513, 1000, 1024)
SERVE_CHECK_N = 3001
#: yt-sim's waves, each a full slot pool (ServeConfig().batch_slots = 32).
SERVE_SLOTS = 32
SERVE_MAX_WIDTH = 1024
#: How many yt-sim responses (top-K, pairs; the first served) the NumPy
#: oracle re-scores on the host: each top-K there is a (1,138,499 x 128)
#: chain, ~1 s.
SERVE_ORACLE_TOPK, SERVE_ORACLE_PAIRS = 2, 8


def hard_phi(np, n, d, seed):
    """Random rows with three duplicated rows (tied scores), two zero rows
    (scores of +0.0 and -0.0), a row and its negation, and two rows whose
    products and sums are subnormal."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n, d)).astype(np.float32)
    phi[5] = phi[9] = phi[n - 1] = phi[3]
    phi[2] = 0.0
    phi[7] = -0.0
    phi[11] = -phi[12]
    phi[13] = np.float32(1e-20) * rng.standard_normal(d).astype(np.float32)
    phi[14] = np.float32(3e-19) * rng.standard_normal(d).astype(np.float32)
    return phi


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (signed zeros told apart), shapes included."""
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def chain_dot_checks(torch, np, dev) -> int:
    """``all_scores`` and ``pair_scores`` against ``ref.py`` on the card bit
    for bit at every SERVE_DIMS x SERVE_BATCHES (widths 1-1,024), then a
    server on the card over each hard phi: pair queries at every
    SERVE_WIDTHS (0 included) and top-K at k 1, 10, 100 and N, every
    response equal to ``oracle_scores`` / ``oracle_topk`` on the host bit
    for bit. Returns the number of cases."""
    import tempfile

    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.kernels.chain_dot import ops, ref
    from repro_torch.runtime.serve import EmbedServer, ServeConfig, oracle_scores, oracle_topk

    n, cases = SERVE_CHECK_N, 0
    rng = np.random.default_rng(400)
    for d in SERVE_DIMS:
        host = hard_phi(np, n, d, seed=400 + d)
        phi = torch.from_numpy(host).to(dev)
        for b in SERVE_BATCHES:
            u = torch.from_numpy(np.concatenate([[3, 2, 13], rng.integers(0, n, b)])[:b]).to(dev)
            if not same_bits(torch, ops.all_scores(phi, u), ref.all_scores_ref(phi, u)):
                raise AssertionError(f"[serve] all_scores d={d} B={b} differs from ref.py")
            cases += 1
            for width in (1, 3, 64, 1000, 1024):
                cand = torch.from_numpy(rng.integers(0, n, (b, width))).to(dev)
                if not same_bits(torch, ops.pair_scores(phi, u, cand),
                                 ref.pair_scores_ref(phi, u, cand)):
                    raise AssertionError(f"[serve] pair_scores d={d} B={b} C={width} differs "
                                         "from ref.py")
                cases += 1
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
            save_checkpoint(root, 0, {"phi_in": host}, meta={"graph_version": 0})
            srv = EmbedServer(ServeConfig(), device=dev)
            srv.offer_snapshot(root)
            specs = [{"u": int(u), "candidates": rng.integers(0, n, w)}
                     for u, w in zip([3, 2, 7, 13, 14, 11] * 3, SERVE_WIDTHS)] + \
                [{"u": u, "k": k} for u in (3, 2, 13, 20) for k in (1, 10, 100, n)]
            for spec, r in zip(specs, srv.serve(specs)):
                if "k" in spec:
                    vals, ids = oracle_topk(host, spec["u"], spec["k"])
                else:
                    vals, ids = oracle_scores(host, spec["u"], spec["candidates"]), \
                        spec["candidates"]
                if not (np.array_equal(r.ids, ids) and r.scores.dtype == np.float32
                        and np.array_equal(r.scores.view(np.uint32), vals.view(np.uint32))):
                    raise AssertionError(f"[serve] d={d}: a served response differs from the "
                                         f"NumPy oracle: {spec if 'k' in spec else spec['u']}")
                cases += 1
    return cases


def chain_dot_bound_ms(b: int, n: int, d: int) -> tuple:
    """(ms, "bytes" | "operations") for scoring b query rows against every
    row of an (n, d) phi: phi read once, the queries and their ids read,
    the (b, n) scores written; the FP32 instructions are 2 b n d (a
    multiply and an add each, which the order pin forbids to fuse) at
    half the card's FP32 FLOP rate (an FMA counts two)."""
    by_bytes = (n * d * 4 + b * d * 4 + b * 8 + b * n * 4) / H100_BYTES_PER_S * 1e3
    by_ops = 2 * b * n * d / (H100_F32_FLOPS / 2) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def serve_waves(np, srv, rng, n: int, kinds) -> list:
    """Submit and tick one wave per kind ("topk10", "topk100", "pairs",
    "mixed"): each a full slot pool of SERVE_SLOTS queries. Returns (kind,
    queries, responses, groups, wall seconds) per wave, groups being the
    top-K k values plus the pair buckets the wave holds (a launch each)."""
    out = []
    for kind in kinds:
        specs = []
        for i in range(SERVE_SLOTS):
            u = int(rng.integers(0, n))
            if kind.startswith("topk") or (kind == "mixed" and i % 2 == 0):
                specs.append({"u": u, "k": int(kind[4:]) if kind.startswith("topk") else 10})
            else:
                specs.append({"u": u, "candidates": rng.integers(
                    0, n, int(rng.integers(1, SERVE_MAX_WIDTH + 1)))})
        qids = [srv.submit(s["u"], s.get("candidates"), k=s.get("k")) for s in specs]
        t0 = time.perf_counter()
        resps = srv.tick()
        wall = time.perf_counter() - t0
        if [r.qid for r in resps] != qids or srv.stats()["queue_depth"]:
            raise AssertionError(f"[serve] a {kind} wave did not answer its {SERVE_SLOTS} queries")
        buckets = {max(1, 1 << (len(s["candidates"]) - 1).bit_length())
                   for s in specs if "candidates" in s}
        groups = len({s["k"] for s in specs if "k" in s}) + len(buckets)
        out.append((kind, specs, resps, groups, wall))
    return out


def check_waves(torch, np, waves, phis: dict, host_phis: dict, dev, oracle_quota=(0, 0)) -> int:
    """Every response equal, bit for bit, to ``ref.py`` on the card over the
    phi of the version it is stamped with (top-K: the ids and values of
    ``topk_from_scores`` on ``all_scores_ref``, eight queries at a time;
    pairs: ``pair_scores_ref`` of its own candidates); the first
    ``oracle_quota`` (top-K, pairs) of them also equal to the NumPy oracle
    on the host. Returns how many responses the oracle re-scored."""
    from repro_torch.kernels.chain_dot import ref
    from repro_torch.runtime.serve import oracle_scores, oracle_topk

    topk_left, pairs_left = oracle_quota
    for kind, specs, resps, _, _ in waves:
        for k in sorted({s["k"] for s in specs if "k" in s}):
            idx = [i for i, s in enumerate(specs) if s.get("k") == k]
            for lo in range(0, len(idx), 8):
                part = idx[lo:lo + 8]
                by_version = {}
                for i in part:
                    by_version.setdefault(resps[i].served_version, []).append(i)
                for v, rows in by_version.items():
                    u = torch.tensor([specs[i]["u"] for i in rows], device=dev)
                    vals, ids = ref.topk_from_scores(ref.all_scores_ref(phis[v], u), u, k)
                    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
                    for j, i in enumerate(rows):
                        r = resps[i]
                        if not (np.array_equal(r.ids, ids[j]) and
                                np.array_equal(r.scores.view(np.uint32), vals[j].view(np.uint32))):
                            raise AssertionError(f"[serve] {kind} top-{k} of u={r.u} on version "
                                                 f"{v} differs from ref.py on the card")
                        if topk_left > 0:
                            ov, oi = oracle_topk(host_phis[v], r.u, k)
                            if not (np.array_equal(r.ids, oi) and
                                    np.array_equal(r.scores.view(np.uint32), ov.view(np.uint32))):
                                raise AssertionError(f"[serve] top-{k} of u={r.u} on version {v} "
                                                     "differs from the NumPy oracle")
                            topk_left -= 1
        for s, r in zip(specs, resps):
            if "candidates" not in s:
                continue
            phi = phis[r.served_version]
            want = ref.pair_scores_ref(phi, torch.tensor([s["u"]], device=dev),
                                       torch.from_numpy(s["candidates"][None]).to(dev))[0]
            if not (np.array_equal(r.ids, s["candidates"]) and
                    np.array_equal(r.scores.view(np.uint32), want.cpu().numpy().view(np.uint32))):
                raise AssertionError(f"[serve] pair scores of u={r.u} ({len(r.ids)} candidates) "
                                     f"on version {r.served_version} differ from ref.py")
            if pairs_left > 0:
                ov = oracle_scores(host_phis[r.served_version], r.u, s["candidates"])
                if not np.array_equal(r.scores.view(np.uint32), ov.view(np.uint32)):
                    raise AssertionError(f"[serve] pair scores of u={r.u} on version "
                                         f"{r.served_version} differ from the NumPy oracle")
                pairs_left -= 1
    return oracle_quota[0] - topk_left + oracle_quota[1] - pairs_left


class TimedGate:
    """A ``SnapshotGate`` whose ``admit`` seconds are kept (``seconds``)."""

    def __init__(self):
        from repro_torch.runtime.health import SnapshotGate, SnapshotGateConfig

        self.gate = SnapshotGate(SnapshotGateConfig())
        self.seconds = []

    def admit(self, phi, **kw):
        t0 = time.perf_counter()
        try:
            return self.gate.admit(phi, **kw)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def serve_phase(torch, np, counters, replicas, dev) -> dict:
    """``[serve]``: embedding serving on yt-sim at full size. ``replicas``
    is [main]'s (2, N, d) phi_in ([main k=2]'s and [main k=1]'s), the
    version-1 snapshot; version 2 is [main k=1]'s phi and version 3 [main
    k=2]'s. First the kernel's checks (``chain_dot_checks``). Then, through
    an ``EmbedServer`` on the card: version 1 offered from a snapshot in the
    reference's layout (the replica mean at full size, taken on the host,
    must equal NumPy's), waves of 32 top-K at k 10 and 100, of pairs at
    widths 1-1,024 and mixed; version 2 swapped in past a torn step
    directory numbered above both, its waves; an offer of version 3 under
    a ``swap`` drill must leave version 2 serving, and the retried offer
    must swap. Every response must equal ``ref.py`` on the card for the
    version it is stamped with, a few of each version's the NumPy oracle,
    and chain_dot must have launched once per top-K group and pair bucket
    of the waves. Then the kernel's, ``ref.py``'s, the library's and the
    sort's times at a 32-query top-K wave."""
    import shutil
    import tempfile

    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.kernels.chain_dot import ops, ref
    from repro_torch.runtime.faults import NULL_INJECTOR, FaultInjector, SimulatedFailure
    from repro_torch.runtime.serve import EmbedServer, ServeConfig

    t_phase = time.perf_counter()
    cases = chain_dot_checks(torch, np, dev)
    log(f"[serve] chain_dot equals ref.py on the card bit for bit at {cases} cases (d "
        f"{list(SERVE_DIMS)}, B {list(SERVE_BATCHES)}, widths 0-1,024, k 1 / 10 / 100 / N; ties, "
        f"signed zeros, subnormals) and the NumPy oracle at every served response of them "
        f"({time.perf_counter() - t_phase:.2f} s)")

    s, n, d = replicas.shape
    host = {1: replicas.cpu().numpy()}
    host[2], host[3] = host[1][1], host[1][0]
    mean = host[1].mean(axis=0)                     # NumPy's replica mean, the oracle's phi
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    gate = TimedGate()
    srv = EmbedServer(ServeConfig(), gate=gate, device=dev)
    if srv.cfg.batch_slots != SERVE_SLOTS:
        raise AssertionError("[serve] the waves assume ServeConfig's 32 slots")
    rng = np.random.default_rng(401)
    torch.cuda.reset_peak_memory_stats()
    phis, oracle_phis, seconds, waves = {}, {}, {}, []

    def offer(v: int, expect: bool = True, save: bool = True) -> None:
        if save:
            t0 = time.perf_counter()
            save_checkpoint(tmp, v, {"phi_in": host[v]},
                            meta={"graph_version": v, "global_step": v})
            seconds[f"save v{v}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        swapped = srv.offer_snapshot(tmp)
        seconds[f"offer v{v}"] = time.perf_counter() - t0
        seconds[f"gate v{v}"] = gate.seconds[-1]
        if swapped != expect or (expect and srv.active_version() != v):
            raise AssertionError(f"[serve] offer of version {v}: swapped {swapped}, active "
                                 f"{srv.active_version()}")
        if expect:
            phis[v] = srv._active.phi
            oracle_phis[v] = mean if v == 1 else host[v]

    reset_counts(torch, counters)
    offer(1)
    t0 = time.perf_counter()
    load_checkpoint(tmp, only=("phi_in",))
    seconds["load v1"] = time.perf_counter() - t0
    if not np.array_equal(srv.active_phi().view(np.uint32), mean.view(np.uint32)):
        raise AssertionError("[serve] version 1's served phi is not NumPy's replica mean")
    waves += serve_waves(np, srv, rng, n, ("topk10", "topk100", "pairs", "pairs", "mixed"))
    torn = os.path.join(tmp, "step_00000099")
    os.makedirs(torn)
    with open(os.path.join(torn, "phi_in.npy"), "wb") as f:
        f.write(b"\x93NUMPY torn candidate")
    offer(2)
    waves += serve_waves(np, srv, rng, n, ("topk10", "pairs"))
    srv.faults = FaultInjector(plan={"swap": [0]})
    try:
        offer(3)
        raise AssertionError("[serve] the swap drill did not fire")
    except SimulatedFailure:
        pass
    if srv.active_version() != 2 or srv.faults.fired != [("swap", 0)]:
        raise AssertionError(f"[serve] after the swap drill version {srv.active_version()} "
                             "serves, not 2")
    waves += serve_waves(np, srv, rng, n, ("mixed",))
    srv.faults = NULL_INJECTOR
    offer(3, save=False)
    waves += serve_waves(np, srv, rng, n, ("topk10",))
    counts = read_counts(torch, counters)
    launches = counts["others"]["chain_dot"]
    groups = sum(w[3] for w in waves)
    stamped = [r.served_version for w in waves for r in w[2]]
    st = srv.stats()
    log(f"[serve] yt-sim |V|={n} d={d}: {len(waves)} waves of {SERVE_SLOTS} on versions "
        f"{sorted(set(stamped))}; chain_dot launches {launches} for {groups} top-K groups and "
        f"pair buckets; other kernels {dict(counts['others'], chain_dot=0)}, K1 {counts['k1']}; "
        f"swaps {st['swaps']}, availability {st['availability']}, served by version "
        f"{st['served_by_version']}")
    if launches != groups or counts["k1"] or any(v for k, v in counts["others"].items()
                                                 if k != "chain_dot"):
        raise AssertionError(f"[serve] launches {counts}, expected chain_dot {groups}")
    if st["availability"] != 1.0 or st["swaps"] != 3 or \
            stamped != [1] * 5 * SERVE_SLOTS + [2] * 3 * SERVE_SLOTS + [3] * SERVE_SLOTS:
        raise AssertionError(f"[serve] versions served {st['served_by_version']}, stats {st}")
    t0 = time.perf_counter()
    checked = check_waves(torch, np, waves, phis, oracle_phis, dev,
                          (SERVE_ORACLE_TOPK, SERVE_ORACLE_PAIRS))
    log(f"[serve] every response of {len(stamped)} equals ref.py on the card for its stamped "
        f"version bit for bit, {checked} of them the NumPy oracle too "
        f"({time.perf_counter() - t0:.2f} s)")
    by_kind = {}
    for kind, _, _, _, wall in waves:
        by_kind.setdefault(kind, []).append(wall)
    log("[serve] wave wall (host clock, the responses on the host) by kind, in serving order: "
        + ", ".join(f"{k} {[round(t * 1e3, 3) for t in v]} ms" for k, v in by_kind.items()))
    log("[serve] snapshot seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f" ({s} x {n} x {d} float32 replicas in version 1)")

    # Times at a 32-query top-K wave on version 3's phi.
    phi = phis[3]
    u = torch.from_numpy(rng.integers(0, n, SERVE_SLOTS)).to(dev)
    scores = ops.all_scores(phi, u)
    err = float((scores - ref.all_scores_ref(phi, u)).abs().max())
    ms = time_ms(torch, lambda: ops.all_scores(phi, u), 20)
    plain_ms = time_ms(torch, lambda: ref.all_scores_ref(phi, u), 3)
    sort_ms = time_ms(torch, lambda: ref.topk_from_scores(scores, u, 100), 10)
    lib_ms = time_ms(torch, lambda: torch.topk(phi[u] @ phi.T, 100, dim=1), 20)
    cand = torch.from_numpy(rng.integers(0, n, (SERVE_SLOTS, SERVE_MAX_WIDTH))).to(dev)
    pair_ms = time_ms(torch, lambda: ops.pair_scores(phi, u, cand), 20)
    pair_plain_ms = time_ms(torch, lambda: ref.pair_scores_ref(phi, u, cand), 10)
    bound_ms, bound_by = chain_dot_bound_ms(SERVE_SLOTS, n, d)
    by_bytes = chain_dot_bound_ms(1, n, d)[0]
    ms1 = time_ms(torch, lambda: ops.all_scores(phi, u[:1]), 20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] chain_dot all_scores at B={SERVE_SLOTS}, N={n}, d={d}: {ms:.4f} ms a launch "
        f"against its bound {bound_ms:.6f} ms (bound by {bound_by}: {2 * SERVE_SLOTS * n * d} "
        f"FP32 instructions, no FMA; {(n + SERVE_SLOTS) * d * 4 + SERVE_SLOTS * (8 + 4 * n)} "
        f"bytes), {bound_ms / ms * 100:.2f}% of it; at B=1 {ms1:.4f} ms against "
        f"{by_bytes:.6f} (bytes); ref.py {plain_ms:.3f} ms; the library's scores up to "
        f"rounding (phi[u] @ phi.T, TF32 off, and torch.topk k=100) {lib_ms:.4f} ms; the "
        f"stable sort of the (32, N) scores for top-K {sort_ms:.4f} ms; pair_scores at "
        f"({SERVE_SLOTS}, {SERVE_MAX_WIDTH}) {pair_ms:.4f} ms, ref.py {pair_plain_ms:.3f} ms; "
        f"max abs err {err}; peak device memory {peak:.3f} GiB; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    del phis, scores
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms, "sort_ms": sort_ms,
            "ms_b1": ms1, "bound_ms_b1": by_bytes, "pair_ms": pair_ms,
            "pair_plain_ms": pair_plain_ms, "cases": cases}


def serve_ingest(torch, np, counters, srv, stage: str, seed: int, dev) -> tuple:
    """``[ingest fl-sim]``'s reads: one mixed wave of 32 (top-K at k = 10 and
    pairs at widths 1-1,024) on the server the IngestDriver publishes to, every
    launch count set to 0 before and read after; each response must equal
    the NumPy oracle of the version it is stamped with, bit for bit.
    Returns (version served, chain_dot launches)."""
    from repro_torch.runtime.serve import oracle_scores, oracle_topk

    reset_counts(torch, counters)
    (kind, specs, resps, groups, wall), = serve_waves(np, srv, np.random.default_rng(seed),
                                                      srv._active.phi.shape[0], ("mixed",))
    counts = read_counts(torch, counters)
    launches = counts["others"]["chain_dot"]
    versions = {r.served_version for r in resps}
    phi = srv.active_phi()
    for s, r in zip(specs, resps):
        if "k" in s:
            vals, ids = oracle_topk(phi, s["u"], s["k"])
        else:
            vals, ids = oracle_scores(phi, s["u"], s["candidates"]), s["candidates"]
        if not (np.array_equal(r.ids, ids) and
                np.array_equal(r.scores.view(np.uint32), vals.view(np.uint32))):
            raise AssertionError(f"[ingest fl-sim] {stage}: the response to u={r.u} differs "
                                 "from the NumPy oracle of its version")
    log(f"[ingest fl-sim] {stage}: a mixed wave of {len(resps)} served on version "
        f"{sorted(versions)} in {wall * 1e3:.3f} ms, every response equal to that version's "
        f"NumPy oracle; chain_dot launches {launches} for {groups} groups")
    if len(versions) != 1 or launches != groups or counts["k1"] or \
            any(v for k, v in counts["others"].items() if k != "chain_dot"):
        raise AssertionError(f"[ingest fl-sim] {stage}: versions {versions}, launches {counts}, "
                             f"expected chain_dot {groups}")
    return versions.pop(), launches


def flash_check(torch, fa_ops, fa_ref, case, seed, sm_scale=None, v_mode="own",
                scaled=False) -> tuple:
    """Kernel (through ``ops.attend``, the model layers' entry, which takes
    every key length) against ``mha_reference`` on the card; raises outside
    the tolerance. With ``scaled`` (non-causal over many keys, where the
    outputs are as small as the tolerance) the error must also be within
    ``bench.SCALED_TOL`` of the outputs' scale. With ``v_mode`` "k" (MLA's
    call) the kernel's first 256 columns must also match ``mha_reference``
    on the zero-padded latent (the reference's v). Returns the max abs
    error against it; in bfloat16 the one against ``mha_chunked`` (which
    rounds P to bf16 for P.V, as the wgmma kernel does), else None; and
    ``bench.scaled_errors`` against ``mha_reference``."""
    from repro_torch.kernels.flash_attention import bench as fa_bench

    b, hq, hkv, sq, skv, d, causal, q_offset, dtype = case
    q, k, v = fa_bench.inputs(torch, b, hq, hkv, sq, skv, d, seed, getattr(torch, dtype), v_mode)
    kw = dict(causal=causal, q_offset=q_offset, sm_scale=sm_scale)
    got = fa_ops.attend(q, k, v, **kw).float()
    want = fa_ref.mha_reference(q, k, v, **kw).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = FLASH_TOL[dtype]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention {case}: differs by {err:.3e}")
    rel = fa_bench.scaled_errors(got, want)
    if scaled and any(r > lim for r, lim in zip(rel, fa_bench.SCALED_TOL[dtype])):
        raise AssertionError(f"flash_attention {case}: scaled errors (max, mean) {rel} exceed "
                             f"{fa_bench.SCALED_TOL[dtype]}")
    if v_mode == "k":
        rank = fa_bench.LATENTS[d][0]
        padded = torch.nn.functional.pad(k[..., :rank], (0, d - rank))
        lat = fa_ref.mha_reference(q, k, padded, **kw)[..., :rank].float()
        if not torch.allclose(got[..., :rank], lat, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {case} with v = k: the latent's columns "
                                 f"differ by {(got[..., :rank] - lat).abs().max().item():.3e}")
        err = max(err, (got[..., :rank] - lat).abs().max().item())
        del padded, lat
    chunked = None
    if dtype == "bfloat16":
        chunked = fa_ref.mha_chunked(q, k, v, **kw).float()
        chunked = (got - chunked).abs().max().item()
    return err, chunked, rel


def sass_functions(lib) -> list:
    """(name, SASS text) of every kernel in ``lib`` (``cuobjdump -sass``)."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib.library_path())], capture_output=True,
                          text=True, check=True).stdout
    return [(fn.split("\n", 1)[0].strip(), fn) for fn in sass.split("Function : ")[1:]]


# The bf16 flash kernels by route: (SASS name, head dims, builds per dim).
# Head dims up to 128 take one ``flash_kernel_sm90`` each; 288 takes
# ``flash_kernel_sm90_wide`` (O's columns split across two consumer
# warpgroups) and 576 ``flash_kernel_sm90_split3`` (across three), each
# built twice: v read apart, and v = k (one tile for both products).
FLASH_ROUTES = (("flash_kernel_sm90_split3", (576,), 2), ("flash_kernel_sm90_wide", (288,), 2),
                ("flash_kernel_sm90", (16, 32, 64, 96, 112, 128), 1))


def sass_check(lib, head_dims) -> None:
    """Every bf16 flash kernel in ``lib``'s SASS must issue wgmma (HGMMA)
    and TMA tile loads (UTMALDG), and each route of ``FLASH_ROUTES`` must
    hold one build per head dim (two above 128); raises otherwise."""
    found = {route: 0 for route, _, _ in FLASH_ROUTES}
    for name, fn in sass_functions(lib):
        route = next((r for r, _, _ in FLASH_ROUTES if r in name), None)
        if route is None:
            continue
        found[route] += 1
        hgmma, utmaldg = fn.count("HGMMA"), fn.count("UTMALDG")
        log(f"[check] {lib.name} SASS {name} ({route}): {hgmma} HGMMA, {utmaldg} UTMALDG")
        if not (hgmma and utmaldg):
            raise AssertionError(f"{name} issues no HGMMA or no UTMALDG")
    want = {route: builds * len(dims) for route, dims, builds in FLASH_ROUTES}
    if found != want or sorted(d for _, dims, _ in FLASH_ROUTES for d in dims) != \
            sorted(head_dims):
        raise AssertionError(f"bf16 flash kernels in the SASS {found}, expected {want}")
    log("[check] " + "; ".join(f"head dims {list(dims)} take {route} (wgmma + TMA)"
                               for route, dims, _ in FLASH_ROUTES))


def ssd_sass_check(lib, wide_lib) -> None:
    """The SSD scan's product kernels must run on the tensor cores in TF32:
    in the first route's library wgmma (HGMMA ... TF32) in both kernels and
    the C B^T blocks of the state kernel by mma.sync (HMMA ... TF32); in
    the wide route's, HGMMA or HMMA ... TF32 in each product kernel (C B^T
    with the local states, and the output). Raises otherwise."""
    kernels = {lib: ("ssd_chunk_state_kernel", "ssd_chunk_out_kernel"),
               wide_lib: ("wide_cb_state_kernel", "wide_out_kernel")}
    for library, names in kernels.items():
        found = set()
        for name, fn in sass_functions(library):
            for kernel in names:
                if kernel not in name:
                    continue
                lines = fn.splitlines()
                hgmma = sum("HGMMA" in ln and "TF32" in ln for ln in lines)
                hmma = sum("HMMA" in ln and "TF32" in ln for ln in lines)
                log(f"[check] {library.name} SASS {kernel}: {hgmma} HGMMA TF32, "
                    f"{hmma} HMMA TF32")
                first_route = library is lib
                if (first_route and (not hgmma or (kernel == "ssd_chunk_state_kernel"
                                                   and not hmma))) \
                        or not (hgmma or hmma):
                    raise AssertionError(f"{kernel} issues no tensor-core TF32 product")
                found.add(kernel)
        if found != set(names):
            raise AssertionError(f"{library.name} kernels in the SASS: {sorted(found)}, "
                                 f"expected {sorted(names)}")


def flash_times(torch, fa_ops, fa_ref, case, sm_scale=None, v_mode="own") -> dict:
    """Kernel, plain and SDPA ms and the bound at a prefill case (with
    ``v_mode`` "k", MLA's call: v is k), causal or not (an encoder's or a
    cross-attention's: SDPA with ``is_causal=False``). At a head dim above
    128 SDPA is also timed with k and v expanded to every query head; the
    log names the backend PyTorch picked for each call, and ``library_ms``
    is the faster."""
    from repro_torch.kernels.flash_attention import bench as fa_bench

    b, hq, hkv, sq, skv, d, causal, _, dtype = case
    q, k, v = fa_bench.inputs(torch, b, hq, hkv, sq, skv, d, 7, getattr(torch, dtype), v_mode)
    kw = dict(causal=causal, sm_scale=sm_scale)
    kernel_ms = time_ms(torch, lambda: fa_ops.attend(q, k, v, **kw), 20)
    plain_ms = time_ms(torch, lambda: fa_ref.mha_reference(q, k, v, **kw), 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {"enable_gqa": lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True,
                                        scale=sm_scale)}
    if d > 128:
        kx, vx = (t.expand(b, hq, skv, d) for t in (k, v))
        calls["expanded"] = lambda: sdpa(q, kx, vx, is_causal=causal, scale=sm_scale)
    library = {}
    for name, call in calls.items():
        backend = fa_bench.sdpa_backend(torch, call)
        library[name] = {"backend": backend, "ms": time_ms(torch, call, 20)}
    best = min(library, key=lambda name: library[name]["ms"])
    bound, by = fa_bench.bound_ms(b, hq, hkv, sq, d, q.element_size(), skv=skv, causal=causal)
    log(f"[time] flash_attention at the prefill shape q {tuple(q.shape)} kv {tuple(k.shape)} "
        f"{dtype}{'' if causal else ' non-causal'}"
        + (f", sm_scale {sm_scale:.6f}, v {v_mode}" if sm_scale else "")
        + f": kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        + ", ".join(f"sdpa {name} ({lib['backend']}) {lib['ms']:.4f} ms"
                    for name, lib in library.items())
        + f", bound {bound:.6f} ms ({by}), kernel {kernel_ms / bound:.2f}x the bound")
    shapes = {"q": list(q.shape), "kv": list(k.shape)}
    del q, k, v, calls
    torch.cuda.empty_cache()
    out = {**shapes, "dtype": dtype, "causal": causal, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": library[best]["ms"],
           "library": f"sdpa {best} ({library[best]['backend']})"}
    if d > 128:
        out.update(sm_scale=sm_scale, v=v_mode,
                   library_ms_by_call={name: lib["ms"] for name, lib in library.items()})
    return out


# --- chunked SSD scan (K3) --------------------------------------------------

def ssd_inputs(torch, bh, s, p, n, seed, device, model_decay=False):
    """xdt, b, c ~ N(0, 1); loga ~ -U(0, 0.2) as the reference's kernel tests
    draw it, or with ``model_decay`` as the Mamba2 mixer draws it at init:
    -exp(A_log = 0) * softplus(dt ~ N(0, 1)), about -0.8 per step, so that
    exp(cum_i - cum_j) above a 128-step chunk's diagonal overflows."""
    gen = torch.Generator().manual_seed(seed)
    xdt = torch.randn(bh, s, p, generator=gen)
    if model_decay:
        loga = -torch.nn.functional.softplus(torch.randn(bh, s, generator=gen))
    else:
        loga = -torch.rand(bh, s, generator=gen) * 0.2
    b, c = torch.randn(bh, s, n, generator=gen), torch.randn(bh, s, n, generator=gen)
    return tuple(t.to(device) for t in (xdt, loga, b, c))


def ssd_check(torch, ssd_ops, ssd_ref, case, seed, device, model_decay=False) -> float:
    """Kernel against ``ssd_chunked_ref`` on the card, y and the final state
    within SSD_TOL; raises otherwise, or on a non-finite output. A case of
    5 numbers (BH, S, P, N, chunk) runs the 3-D form; one of 7 (B, H, G, S,
    P, N, chunk) the mixer's form, on (B, H, S, ·) views of (B, S, H, ·)
    tensors with B and C per group, held against ``ssd_chunked_ref`` on
    them broadcast to every head (always with the model's decay); where P
    is 64 it runs a second time with the chunk-state scratch NaN-filled, so
    that a chunk that reads its predecessor's state before it is written
    gives NaN, not what an earlier call left in reused memory."""
    if len(case) == 5:
        bh, s, p, n, chunk = case
        args = ssd_inputs(torch, bh, s, p, n, seed, device, model_decay)
        y, st = ssd_ops.ssd_chunked_scan(*args, chunk=chunk)
        want_y, want_s = ssd_ref.ssd_chunked_ref(*args, chunk=chunk)
    else:
        from repro_torch.kernels.ssm_scan import bench as ssd_bench

        bsz, h, g, s, p, n, chunk = case
        args = ssd_bench.heads_inputs(torch, bsz, h, g, s, p, n, seed, device)
        y, st = ssd_ops.ssd_scan_heads(*args, chunk=chunk)
        if not y.transpose(1, 2).is_contiguous():
            raise AssertionError(f"ssd_scan {case}: y is not in the mixer's (B, S, H, P) layout")
        want_y, want_s = ssd_ops._plain(*args, chunk=chunk)
    outs = [("y", y, want_y), ("state", st, want_s)]
    if len(case) == 7 and p == ssd_ops.HEAD_DIM and n % 8 == 0:
        y2 = torch.empty(bsz, s, h, p, device=device).transpose(1, 2)
        states = torch.full((bsz, h, -(-s // min(chunk, s)), n, p), float("nan"), device=device)
        _, st2 = ssd_ops._run(*args, chunk, y2, states=states)
        outs += [("y (NaN-filled states)", y2, want_y), ("state (NaN-filled states)", st2, want_s)]
    torch.cuda.synchronize()
    if not all(torch.isfinite(got).all() for _, got, _ in outs):
        raise AssertionError(f"ssd_scan {case}: non-finite output")
    err = 0.0
    for name, got, want in outs:
        if not torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL):
            raise AssertionError(f"ssd_scan {case}: {name} differs by "
                                 f"{(got - want).abs().max().item():.3e}")
        err = max(err, (got - want).abs().max().item())
    return err


def ssd_times(torch, ssd_ops, case, device) -> dict:
    """The SSD scan at zamba2's prefill shape with the model's decay: in the
    mixer's form (the main path's call), its plain route, and the 3-D form
    on B and C broadcast to every head; beside the bound with B and C per
    batch (the function the main path computes) and the bound of the same
    function fed B and C broadcast."""
    from repro_torch.kernels.ssm_scan import bench as ssd_bench

    bsz, h, g, s, p, n, chunk = case
    args = ssd_bench.heads_inputs(torch, bsz, h, g, s, p, n, seed=8, device=device)
    ms = time_ms(torch, lambda: ssd_ops.ssd_scan_heads(*args, chunk=chunk), 20)
    plain_ms = time_ms(torch, lambda: ssd_ops._plain(*args, chunk=chunk), 5)
    args3 = ssd_bench.broadcast_3d(*args)
    ms_3d = time_ms(torch, lambda: ssd_ops.ssd_chunked_scan(*args3, chunk=chunk), 20)
    bound, by = ssd_bench.bound_ms(bsz, h, g, s, p, n, chunk)
    bcast, by_b = ssd_bench.bound_ms(bsz, h, h, s, p, n, chunk)
    log(f"[time] ssd_scan at zamba2's prefill shape (B, H, G, S, P, N, chunk) {case} float32: "
        f"kernel {ms:.4f} ms in the mixer's form, {ms_3d:.4f} ms in the 3-D form on B and C "
        f"broadcast; plain {plain_ms:.4f} ms; bound {bound:.6f} ms ({by}) with B and C per "
        f"batch, {bcast:.6f} ms ({by_b}) broadcast; no single PyTorch call computes it")
    del args, args3
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "ms_3d": ms_3d, "bound_ms": bound, "bound_by": by,
            "broadcast_bound_ms": bcast, "shape": list(case)}


def wide_check(torch, ssd_ops, case, seed, device) -> float:
    """The SSD scan's wide route against ``ssd_chunked_ref`` on the card
    (the plain route, B and C expanded to every head), y and the final
    state within SSD_TOL, its chunk-state scratch NaN-filled first (a chunk
    that reads its predecessor's state before it is written reads NaN) and
    its outputs finite; raises otherwise. A case of 6 numbers (B, H, S, P,
    N, chunk) is the mLSTM's scan in the mixer's strided layout, inputs at
    the mLSTM's scale; one of 5 (BH, S, P, N, chunk) a reference test case
    in the 3-D form, forced through the wide route."""
    from repro_torch.kernels.ssm_scan import bench as ssd_bench
    from repro_torch.kernels.ssm_scan import wide

    if len(case) == 6:
        bsz, h, s, p, n, chunk = case
        args = ssd_bench.mlstm_inputs(torch, bsz, h, s, p, n, seed, device)
    else:
        bh, s, p, n, chunk = case
        bsz, h = 1, bh
        x, loga, b, c = ssd_inputs(torch, bh, s, p, n, seed, device, model_decay=True)
        args = (x[None], loga[None], b[None], c[None])
    q = min(chunk, s)
    y = torch.empty(bsz, s, h, p, device=device).transpose(1, 2)
    states = torch.full((bsz, h, -(-s // q), n, p), float("nan"), device=device)
    before = wide.LAUNCHES
    if len(case) == 6:
        y, st = ssd_ops._run(*args, chunk, y, states=states)
    else:
        y, st = ssd_ops._run_wide(*args, q, y, states)
    want_y, want_s = ssd_ops._plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    if wide.LAUNCHES != before + 1:
        raise AssertionError(f"ssd_scan wide {case}: the route did not count its scan")
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
        raise AssertionError(f"ssd_scan wide {case}: non-finite output")
    err = 0.0
    for name, got, want in (("y", y, want_y), ("state", st, want_s)):
        if not torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL):
            raise AssertionError(f"ssd_scan wide {case}: {name} differs by "
                                 f"{(got - want).abs().max().item():.3e}")
        err = max(err, (got - want).abs().max().item())
    return err


def wide_times(torch, ssd_ops, case, device) -> dict:
    """The wide route at the xLSTM's prefill shape (the mixer's call,
    inputs at the mLSTM's scale and layout) and its plain route, beside its
    bound (the TF32 tensor-core peak against the bytes, as for the first
    route); the log also gives the 3xTF32 floor (three TF32 products for
    each, as its kernels run them) and each of its kernels' device time
    from the profiler."""
    from repro_torch.kernels.ssm_scan import bench as ssd_bench

    bsz, h, s, p, n, chunk = case
    args = ssd_bench.mlstm_inputs(torch, bsz, h, s, p, n, seed=9, device=device)
    ms = time_ms(torch, lambda: ssd_ops.ssd_scan_heads(*args, chunk=chunk), 20)
    plain_ms = time_ms(torch, lambda: ssd_ops._plain(*args, chunk=chunk), 5)
    ms2 = time_ms(torch, lambda: ssd_ops.ssd_scan_heads(*args, chunk=chunk), 20)
    bound, by = ssd_bench.bound_ms(bsz, h, h, s, p, n, chunk)
    floor3 = 3 * ssd_bench.scan_work(bsz, h, h, s, p, n, chunk)[1] \
        / ssd_bench.H100_TF32_FLOPS * 1e3
    by_kernel = ssd_bench.kernel_times(
        torch, lambda: ssd_ops.ssd_scan_heads(*args, chunk=chunk), r"wide_\w+")
    log(f"[time] ssd_scan wide route at xlstm-350m's prefill shape (B, H, S, P, N, chunk) "
        f"{case} float32: kernel {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} ms; bound "
        f"{bound:.6f} ms ({by}, TF32 tensor-core peak), {ms / bound:.2f}x; 3xTF32 floor "
        f"{floor3:.6f} ms, {ms / floor3:.2f}x; no single PyTorch call computes it")
    log("[time] ssd_scan wide route by kernel: " + ", ".join(
        f"{k} {t:.4f} ms x{c:.0f}" for k, (t, c) in by_kernel.items()))
    del args
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "ms_by_kernel": {k: t for k, (t, _) in by_kernel.items()},
            "shape": list(case)}


# --- the LM paths -----------------------------------------------------------

def lm_prompts(np, vocab: int):
    """The LM paths' traffic: 8 prompts, lengths uniform on 512..2,048,
    tokens uniform over the vocabulary, from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def leaves(tree):
    """The tensors of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def block_kinds(cfg) -> list:
    """The kind of each of cfg's layers, in order."""
    cyc, n, rem = cfg.layer_cycles
    return list(cyc) * n + list(rem)


def cache_leaves(entry) -> dict:
    """One layer's cache by name: an attention layer's k and v (an MLA
    layer's latent ckv and krope), a Mamba2 layer's conv and ssm, an sLSTM
    layer's c, n and h, or an mLSTM layer's matrix memory (one tensor) as
    "mlstm"."""
    return entry if isinstance(entry, dict) else {"mlstm": entry}


# Position-indexed caches, by name: the axis of their positions. Decode
# writes one position of these and leaves the rest; every other cache is a
# recurrent state that decode overwrites.
POSITION_AXIS = {"k": 2, "v": 2, "ckv": 1, "krope": 1}


def recurrent_states(caches) -> dict:
    """A copy of every recurrent layer's state (Mamba2, mLSTM, sLSTM), by
    layer."""
    return {(g, r, blk): {name: t.clone() for name, t in cache_leaves(entry).items()}
            for g, reps in caches.items() for r, rep in enumerate(reps)
            for blk, entry in rep.items()
            if not set(cache_leaves(entry)) & set(POSITION_AXIS)}


def tap(torch, server, seconds):
    """Record each prefill's and decode step's logits, each wave's caches
    (a prefill makes them, decode updates them in place), a copy of the
    recurrent states after decode steps KV_CHECK_STEPS (decode overwrites
    them), and the wall time of each kind of call (the device drained
    before and after)."""
    calls, wave_caches, snapshots = [], [], []
    prefill, decode = server._prefill, server._decode

    def timed(kind, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = fn(*args)
        torch.cuda.synchronize()
        seconds[kind] += time.perf_counter() - t0
        calls.append(logits)
        if kind == "prefill":
            wave_caches.append(caches)
            snapshots.append({"step": 0})
        else:
            snapshots[-1]["step"] += 1
            step = snapshots[-1]["step"]
            if step in KV_CHECK_STEPS:
                snapshots[-1][step] = recurrent_states(caches)
        return logits, caches

    server._prefill = lambda *a: timed("prefill", prefill, *a)
    server._decode = lambda *a: timed("decode", decode, *a)
    return calls, wave_caches, snapshots


def cache_diff(served, fresh, rows: int, states=None) -> dict:
    """For each kind of cache entry ("kv": every attention layer's k and v
    at positions [0, rows); "ckv" and "krope": every MLA layer's latent at
    those positions; "conv" and "ssm": every Mamba2 layer's state;
    "mlstm": every mLSTM layer's matrix memory; "c", "n" and "h": every
    sLSTM layer's state; the recurrent ones from ``states`` when given,
    else from ``served``), the largest |served - fresh| over that tensor's
    largest |fresh| entry."""
    worst = {}
    for group, reps in fresh.items():
        for r, (rep_served, rep_fresh) in enumerate(zip(served[group], reps)):
            for block, entry in rep_fresh.items():
                for name, want in cache_leaves(entry).items():
                    if name in POSITION_AXIS:
                        kind = "kv" if name in ("k", "v") else name
                        want = want.narrow(POSITION_AXIS[name], 0, rows)
                        got = rep_served[block][name].narrow(POSITION_AXIS[name], 0, rows)
                    else:
                        kind = name
                        src = states[(group, r, block)] if states is not None \
                            else cache_leaves(rep_served[block])
                        got = src[name]
                    want, got = want.float(), got.float()
                    d = (got - want).abs().max().item() / want.abs().max().item()
                    worst[kind] = max(worst.get(kind, 0.0), d)
    return worst


def fmt_diff(diff: dict, bounds: dict) -> str:
    return ", ".join(f"{k} {v:.5f} (bound {bounds[k]})" for k, v in sorted(diff.items()))


def kv_cache_check(torch, np, server, prefill, waves, calls, wave_caches, snapshots,
                   bounds) -> tuple:
    """For each wave and n in KV_CHECK_STEPS, a fresh prefill over the
    wave's left-padded prompts plus its first n generated tokens must give
    decode step n's last-token logits, within bounds["logits"] of the
    largest |logit|, and the served caches (every attention layer's k and
    v, or MLA layer's ckv and krope, at the first plen + n positions; every
    recurrent layer's state after step n), each kind within bounds[kind] of
    its tensor's largest entry. Returns
    the worst logits ratio and the worst of each kind."""
    worst, worst_state = 0.0, {}
    per_wave = LM_NEW_TOKENS                    # one prefill + budget-1 decode steps
    for w, wave in enumerate(waves):
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), plen + LM_NEW_TOKENS), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):plen] = r.prompt
            toks[i, plen:] = r.output
        for n in KV_CHECK_STEPS:
            fresh, fresh_caches = prefill(
                server.params, {"tokens": torch.as_tensor(toks[:, :plen + n], device=server.device)})
            step = calls[w * per_wave + n].float()
            fresh = fresh.float()
            diff = (fresh - step).abs().max().item()
            scale = step.abs().max().item()
            state = cache_diff(wave_caches[w], fresh_caches, plen + n, snapshots[w][n])
            log(f"[lm] wave {w} step {n}: fresh prefill vs decode max |diff| {diff:.4f} "
                f"(max |logit| {scale:.2f}); cache over positions 0..{plen + n - 1} differs "
                f"by, of the largest entry: {fmt_diff(state, bounds)}")
            if not diff <= bounds["logits"] * scale:
                raise AssertionError(f"wave {w} step {n}: decode logits differ by {diff} "
                                     f"> {bounds['logits']} x {scale}")
            for kind, d in state.items():
                if not d <= bounds[kind]:
                    raise AssertionError(f"wave {w} step {n}: the served {kind} cache differs "
                                         f"from a fresh prefill's by {d} > {bounds[kind]}")
            top2 = step.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > diff
            if not torch.equal(fresh.argmax(-1)[sure], step.argmax(-1)[sure]):
                raise AssertionError(f"wave {w} step {n}: argmax differs where the "
                                     f"top-2 margin exceeds {diff}")
            worst = max(worst, diff / scale)
            for kind, d in state.items():
                worst_state[kind] = max(worst_state.get(kind, 0.0), d)
            del fresh_caches
    return worst, worst_state


def _entries(caches, name):
    for reps in caches.values():
        for rep in reps:
            for entry in rep.values():
                if isinstance(entry, dict) and name in entry:
                    yield entry


def cache_mutation(torch, np, server, prefill, decode, wave, kinds, bounds,
                   fresh_prefill=None, first_picks=None) -> None:
    """The power of ``kv_cache_check``: decode step 1 of ``wave`` with a
    fault must fail it, against a fresh prefill (by ``fresh_prefill`` when
    given: an MoE model's, routed as the served run was). With attention layers: the cache length off
    by -1 or +1 (the new token's key and value land in the wrong slot, and
    its rope phase shifts with it), and the rope phase alone off by +1
    (decoded at +1, then its entries moved back to the right slot); each
    must move the k/v cache beyond its bound (with MLA layers: the length
    faults the latent ckv, the phase fault the rope key krope, which alone
    carries the phase). With Mamba2 layers: the conv
    window shifted back by one step before the decode (it sees
    x_{t-3}, x_{t-3}, x_{t-2}, x_t), which must move the conv state beyond
    its bound, and a decode step that skips the decay exp(loga), which
    must move the ssm state beyond its bound. With mLSTM layers: a decode
    step that skips the decay, which must move the mLSTM state beyond its
    bound; with sLSTM layers: its state (c, n, h) reset to the initial one
    before the decode step, which must move c beyond its bound. With MoE
    layers: the gate weights left unnormalised (the top-k probabilities
    as they come), and the shared expert skipped, each of which must move
    the logits or a cache beyond its bound. The logits' difference is
    printed beside each, and with ``first_picks`` (the fresh prefill's own
    picks in the first MoE layer at the decoded token) the decoded tokens
    whose picks there differ from them."""
    from repro_torch.models import mamba2 as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import xlstm as xlstm_mod

    plen = max(len(r.prompt) for r in wave)
    toks = np.zeros((len(wave), plen + 1), np.int64)
    for i, r in enumerate(wave):
        toks[i, plen - len(r.prompt):plen] = r.prompt
        toks[i, plen] = r.output[0]
    toks = torch.as_tensor(toks, device=server.device)
    fresh, fresh_caches = (fresh_prefill or prefill)(server.params, {"tokens": toks})
    fresh = fresh.float()
    scale = fresh.abs().max().item()

    latent = any(True for _ in _entries(fresh_caches, "ckv"))
    names = ("ckv", "krope") if latent else ("k", "v")

    def shift_kv_back(caches):
        for kv in _entries(caches, names[0]):
            for name in names:
                rows = kv[name].movedim(POSITION_AXIS[name], 0)
                rows[plen] = rows[plen + 1]
                rows[plen + 1] = 0

    def shift_conv(caches):
        for st in _entries(caches, "conv"):
            st["conv"][:, 1:] = st["conv"][:, :-1].clone()

    def reset_slstm(caches):
        for st in _entries(caches, "c"):
            st["c"].zero_()
            st["n"].fill_(xlstm_mod.EPS)
            st["h"].zero_()

    orig_step = mamba_mod.ssd_decode_step
    no_decay = lambda state, xdt, loga, b, c: orig_step(state, xdt, torch.zeros_like(loga), b, c)
    pick = moe_mod.pick

    def unnormalised(xt, p, cfg):
        _, gate_e, probs = pick(xt, p, cfg)
        return probs.gather(1, gate_e), gate_e, probs

    # (name, kind that must fail ("any": the logits or any cache), cache_len
    # shift, before, after, (module, attribute, stand-in) for the decode step)
    faults = []
    if "a" in kinds:
        slot, phase = ("ckv", "krope") if latent else ("kv", "kv")
        faults += [("cache length -1", slot, -1, None, None, None),
                   ("cache length +1", slot, 1, None, None, None),
                   ("rope phase +1", phase, 1, None, shift_kv_back, None)]
    if "m" in kinds:
        faults += [("conv window shifted by one", "conv", 0, shift_conv, None, None),
                   ("decode skips the decay exp(loga)", "ssm", 0, None, None,
                    (mamba_mod, "ssd_decode_step", no_decay))]
    if "x" in kinds:
        faults += [("mLSTM decode skips the decay exp(log f)", "mlstm", 0, None, None,
                    (xlstm_mod, "ssd_decode_step", no_decay))]
    if "s" in kinds:
        faults += [("sLSTM state reset before the decode step", "c", 0, reset_slstm, None,
                    None)]
    if server.cfg.moe:
        faults += [("MoE gate weights left unnormalised", "any", 0, None, None,
                    (moe_mod, "pick", unnormalised)),
                   ("MoE shared expert skipped", "any", 0, None, None,
                    (moe_mod, "mlp", lambda x, p: torch.zeros_like(x)))]
    for fault, kind, shift, before, after, patch in faults:
        _, caches = prefill(server.params, {"tokens": toks[:, :plen]})
        if before:
            before(caches)
        if patch:
            mod, name, stand_in = patch
            orig = getattr(mod, name)
            setattr(mod, name, stand_in)
        try:
            with RouteTap() as routes:
                step, caches = decode(server.params, caches, toks[:, plen:], plen + shift)
        finally:
            if patch:
                setattr(mod, name, orig)
        if after:
            after(caches)
        state = cache_diff(caches, fresh_caches, plen + 1)
        logit = (step.float() - fresh).abs().max().item() / scale
        over = [k for k, v in {**state, "logits": logit}.items() if v > bounds[k]]
        moved = ""
        if first_picks is not None:
            same = (routes.calls[0].gate_e[:, :, None] == first_picks[:, None, :]).any(-1)
            moved = (f"; the first MoE layer's picks differ for "
                     f"{int((same.sum(-1) < first_picks.shape[1]).sum())} of {len(wave)} tokens")
        log(f"[lm] mutation {fault}: cache differs by, of the largest entry: "
            f"{fmt_diff(state, bounds)}; logits by {logit:.5f} of the largest "
            f"(bound {bounds['logits']}){moved}")
        if not (over if kind == "any" else kind in over):
            raise AssertionError(f"the cache check misses a fault ({fault}): "
                                 f"{ {**state, 'logits': logit} } within {bounds}")
        del caches
    del fresh_caches


def slstm_share(torch, np, prefill, params, waves, device) -> list:
    """Each wave's prefill again, its sLSTM layers timed apart (the device
    drained before and after each): [(prompt length, prefill s, sLSTM s)]."""
    from repro_torch.models import xlstm as xlstm_mod

    orig = xlstm_mod.slstm_mixer
    spent = [0.0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    rows = []
    xlstm_mod.slstm_mixer = timed
    try:
        for wave in waves:
            plen = max(len(r.prompt) for r in wave)
            toks = np.zeros((len(wave), plen), np.int64)
            for i, r in enumerate(wave):
                toks[i, plen - len(r.prompt):] = r.prompt
            spent[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": torch.as_tensor(toks, device=device)})
            torch.cuda.synchronize()
            rows.append((plen, time.perf_counter() - t0, spent[0]))
    finally:
        xlstm_mod.slstm_mixer = orig
    return rows


class RouteTap:
    """While on, keeps every ``moe.plan`` call's plan (its device tensors:
    no copy, no sync) in ``calls``, one per MoE layer of each model call."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.calls = moe_mod, []

    def __enter__(self):
        plan = self.orig = self.mod.plan

        def recorded(*args):
            r = plan(*args)
            self.calls.append(r)
            return r
        self.mod.plan = recorded
        return self

    def __exit__(self, *exc):
        self.mod.plan = self.orig


def moe_drops(torch, cfg, routes, layers: int, prefills: int) -> None:
    """Log the dropped (token, slot) pairs of each model call of a served
    run (``routes``: its ``RouteTap`` calls, ``layers`` per model call,
    each wave's prefill then its decode steps), summed over the layers."""
    per_call = torch.stack([(~r.keep).sum() for r in routes]).view(-1, layers).sum(1).tolist()
    pairs = [routes[c * layers].keep.numel() * layers for c in range(len(per_call))]
    caps = [routes[c * layers].capacity for c in range(len(per_call))]
    per_wave = len(per_call) // prefills
    pre = [per_call[w * per_wave] for w in range(prefills)]
    dec = [d for c, d in enumerate(per_call) if c % per_wave]
    dec_caps = sorted({caps[c] for c in range(len(caps)) if c % per_wave})
    log(f"[lm] {cfg.name} at capacity_factor {cfg.capacity_factor}: dropped (token, slot) pairs "
        f"summed over {layers} MoE layers: prefill " + ", ".join(
            f"wave {w} {pre[w]} of {pairs[w * per_wave]} (capacity {caps[w * per_wave]})"
            for w in range(prefills))
        + f"; decode steps (capacity {dec_caps}) min {min(dec)}, median "
        f"{sorted(dec)[len(dec) // 2]}, max {max(dec)} of {pairs[1]} a step, {sum(dec)} in all")


class PinnedRoutes:
    """While on, ``moe.pick`` takes its experts from ``picks`` (one (T, k)
    tensor per MoE layer, in call order), their gate weights gathered from
    the call's own probabilities and renormalised, and keeps in ``own`` the
    experts the router would have picked itself."""

    def __init__(self, picks):
        from repro_torch.models import moe as moe_mod

        self.mod, self.picks, self.own = moe_mod, iter(picks), []

    def __enter__(self):
        pick = self.orig = self.mod.pick

        def pinned(xt, p, cfg):
            _, own, probs = pick(xt, p, cfg)
            self.own.append(own)
            gate_e = next(self.picks)
            gate_w = probs.gather(1, gate_e)
            return gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), gate_e, probs
        self.mod.pick = pinned
        return self

    def __exit__(self, *exc):
        self.mod.pick = self.orig


def moe_consistency(torch, np, cfg, params, prompts, device) -> None:
    """An MoE model's cached decode does not compute what a fresh prefill of
    the same tokens computes: its capacity is per call (1 for 4 decode
    slots), so it drops other pairs. So the check serves the same waves
    again at the no-drop capacity_factor E / top_k, where every expert's
    capacity is the call's token count, and no pair may drop. Even so the
    router's discrete choices amplify bf16 rounding: at the reference's
    init the routed experts' output is ~100x the attention's, a near-tie
    decided the other way moves the next layers' router inputs, and over
    the layers most choices go their own way (PERF.md). So each fresh
    prefill is routed as the served run was (the served prefill's picks for
    the prompt, decode step i's for position plen + i - 1; the gate weights
    from the fresh prefill's own probabilities): decode step n must match
    it (``kv_cache_check``: the logits and the caches), the choices the
    fresh prefill would make differently at the decoded tokens are
    counted, and the cache and MoE faults must fail the check
    (``cache_mutation``). In the first MoE layer no earlier routing reaches
    the router's input, so the fresh prefill's own picks there are those of
    a fresh prefill that routes itself, and they must differ from the
    decode's for no more than FIRST_LAYER_FLIPS of the decoded tokens.
    Fresh prefills of wave 0 that route themselves are compared too, and
    printed. The served configuration keeps
    its published factor: this override lives only here."""
    from repro_torch.runtime.server import Request, Server, ServerConfig

    nd = dataclasses.replace(cfg, capacity_factor=cfg.n_routed_experts / cfg.top_k)
    layers, k = block_kinds(cfg).count("a"), cfg.top_k
    log(f"[lm] {cfg.name} consistency check at the no-drop capacity_factor "
        f"{nd.capacity_factor:.6f} (E / top_k, only inside this check; the served "
        f"configuration keeps {cfg.capacity_factor})")
    server = Server(nd, params, ServerConfig(batch_slots=LM_SLOTS, max_len=LM_MAX_LEN),
                    device=device)
    prefill, decode = server._prefill, server._decode
    calls, wave_caches, snapshots = tap(torch, server, {"prefill": 0.0, "decode": 0.0})
    with RouteTap() as served:
        done = server.serve([Request(i, p, LM_NEW_TOKENS) for i, p in enumerate(prompts)])
    waves = [done[i:i + LM_SLOTS] for i in range(0, len(done), LM_SLOTS)]
    plen = [max(len(r.prompt) for r in wave) for wave in waves]
    dropped = int(torch.stack([(~r.keep).sum() for r in served.calls]).sum())
    if dropped:
        raise AssertionError(f"{cfg.name}: {dropped} pairs dropped at the no-drop factor")

    def plan(w, n, layer):
        """The served run's picks of decode step n's layer (B, k)."""
        return served.calls[(w * LM_NEW_TOKENS + n) * layers + layer].gate_e

    def picks(w, n):
        """Per layer, the served picks of wave w's prompt and first n tokens."""
        b = len(waves[w])
        return [torch.cat([plan(w, i, layer).view(b, -1, k) for i in range(n + 1)], 1)
                .reshape(-1, k) for layer in range(layers)]

    def differ(w, n, own):
        """Per layer, the decoded tokens whose picks the fresh prefill's
        router (``own``, per layer) would not make."""
        b = len(waves[w])
        out = []
        for layer in range(layers):
            ref = own[layer].view(b, plen[w] + n, k)[:, -1]
            same = (plan(w, n, layer)[:, :, None] == ref[:, None, :]).any(-1).sum(-1)
            out.append(int((same < k).sum()))
        return out

    for n in KV_CHECK_STEPS:        # wave 0, routing itself: printed
        toks = np.zeros((len(waves[0]), plen[0] + n), np.int64)
        for i, r in enumerate(waves[0]):
            toks[i, plen[0] - len(r.prompt):plen[0]] = r.prompt
            toks[i, plen[0]:] = r.output[:n]
        with RouteTap() as own:
            fresh, _ = prefill(params, {"tokens": torch.as_tensor(toks, device=device)})
        step = calls[n].float()
        by_layer = differ(0, n, [r.gate_e for r in own.calls])
        log(f"[lm] {cfg.name} no-drop, wave 0 step {n}, a fresh prefill routing itself: logits "
            f"differ by {(fresh.float() - step).abs().max().item() / step.abs().max().item():.5f}"
            f" of the largest; decoded tokens whose picks differ, by layer: {by_layer}")
        del own, fresh

    order = iter([(w, n) for w in range(len(waves)) for n in KV_CHECK_STEPS])
    flips, first = [], {}

    def pinned_prefill(p, batch):
        w, n = next(order)
        with PinnedRoutes(picks(w, n)) as pin:
            out = prefill(p, batch)
        flips.append((len(waves[w]), differ(w, n, pin.own)))
        if (w, n) == (0, 1):
            first["picks"] = pin.own[0].view(len(waves[0]), plen[0] + 1, k)[:, -1]
        return out

    bounds = BOUNDS[cfg.name]
    worst, worst_state = kv_cache_check(torch, np, server, pinned_prefill, waves, calls,
                                        wave_caches, snapshots, bounds)
    tokens = sum(b for b, _ in flips)
    log(f"[lm] {cfg.name} no-drop: {len(served.calls)} routings served, no pair dropped; routed "
        f"as served, the fresh prefills' own routers would pick otherwise for "
        f"{sum(sum(f) for _, f in flips)} of {tokens * layers} (decoded token, layer) pairs "
        f"({[sum(f) for _, f in flips]} by wave and step; by layer "
        f"{[sum(f[i] for _, f in flips) for i in range(layers)]})")
    # The first MoE layer's router input comes before any routing, so its
    # own picks in the pinned prefills are those of a fresh prefill that
    # routes itself: they must agree with the decode's but for a rare tie.
    first_layer = sum(f[0] for _, f in flips)
    log(f"[lm] {cfg.name} no-drop: the first MoE layer's picks differ between the decode and a "
        f"fresh prefill for {first_layer} of {tokens} decoded tokens (bound "
        f"{FIRST_LAYER_FLIPS * tokens:g})")
    if first_layer > FIRST_LAYER_FLIPS * tokens:
        raise AssertionError(f"{cfg.name}: the first MoE layer's router picks otherwise in the "
                             f"decode than in a fresh prefill for {first_layer} of {tokens} tokens")
    log(f"[lm] {cfg.name} cache consistency (no-drop, routed as served): worst |diff| / max "
        f"|logit| {worst:.5f} (bound {bounds['logits']}); worst cache |diff| / max |entry|: "
        f"{fmt_diff(worst_state, bounds)}")
    del wave_caches, calls, snapshots

    def fresh_prefill(p, batch):
        with PinnedRoutes(picks(0, 1)):
            return prefill(p, batch)
    cache_mutation(torch, np, server, prefill, decode, waves[0], set(block_kinds(cfg)), bounds,
                   fresh_prefill, first["picks"])


def lm_path(torch, np, counters, cfg, prompts, device="cuda") -> dict:
    """Serve ``cfg`` at full width to ``prompts`` with every launch count set
    to 0 just before, check the launches (K2 once per attention layer, K3
    once per Mamba2 layer and its wide route once per mLSTM layer in each
    prefill, nothing else), the outputs and the caches (an MoE model's at
    the no-drop factor: ``moe_consistency``); returns the launch counts read
    just after serving."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import zoo
    from repro_torch.runtime.server import Request, Server, ServerConfig, throughput_stats

    kinds = block_kinds(cfg)
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    heads = (f"MLA: {cfg.num_heads} heads on one latent KV head of {cfg.kv_lora_rank} + "
             f"{cfg.qk_rope_dim}, q_lora_rank {cfg.q_lora_rank}, v_head {cfg.v_head_dim}"
             if cfg.use_mla else
             f"heads {cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}")
    ffn = (f"MoE in every attention layer: {cfg.n_routed_experts} routed experts in "
           f"{moe_mod.padded_experts(cfg)} slots, top-{cfg.top_k}, width {cfg.moe_d_ff}, shared "
           f"width {cfg.n_shared_experts * cfg.moe_d_ff}, capacity_factor {cfg.capacity_factor}"
           if cfg.moe else f"d_ff {cfg.d_ff}")
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({kinds.count('a')} attention, "
        f"{kinds.count('m')} Mamba2, {kinds.count('x')} mLSTM, {kinds.count('s')} sLSTM), "
        f"d {cfg.d_model}, {heads}, {ffn}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters (seed 0; the config's "
        f"param_count() {cfg.param_count()}) in {time.perf_counter() - t0:.2f} s")
    server = Server(cfg, params, ServerConfig(batch_slots=LM_SLOTS, max_len=LM_MAX_LEN),
                    device=device)
    prefill, decode = server._prefill, server._decode
    seconds = {"prefill": 0.0, "decode": 0.0}
    calls, wave_caches, snapshots = tap(torch, server, seconds)
    requests = [Request(i, p, LM_NEW_TOKENS) for i, p in enumerate(prompts)]
    log(f"[lm] {len(requests)} requests, prompt lengths {[len(p) for p in prompts]}, "
        f"{LM_NEW_TOKENS} new tokens each, {LM_SLOTS} slots, cache {LM_MAX_LEN}")

    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    waves = [done[i:i + LM_SLOTS] for i in range(0, len(done), LM_SLOTS)]
    prefills = len(waves)
    n_out = sum(len(r.output) for r in done)
    n_prompt = sum(len(p) for p in prompts)
    stats = throughput_stats(n_out, wall)
    log(f"[lm] {cfg.name} serve wall {wall:.3f} s: prefill {seconds['prefill']:.3f} s "
        f"({prefills} calls, {n_prompt} prompt tokens, "
        f"{n_prompt / seconds['prefill']:.1f} prompt tok/s), decode {seconds['decode']:.3f} s "
        f"({len(calls) - prefills} steps, {seconds['decode'] / (len(calls) - prefills) * 1e3:.3f} "
        f"ms/step); {stats['tokens']} generated tokens, {stats['tok_per_s']:.2f} tok/s")
    log(f"[lm] {cfg.name} peak device memory {peak:.3f} GiB; launches {launches}")
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = kinds.count("a") * prefills
    expected["ssd_scan"] = kinds.count("m") * prefills
    expected["ssd_scan_wide"] = kinds.count("x") * prefills
    if launches != expected:
        raise AssertionError(f"{cfg.name}: launches {launches}, expected {expected} "
                             f"({prefills} prefills)")
    for r in done:
        if r.output is None or r.output.shape != (LM_NEW_TOKENS,) or \
                not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    if not all(torch.isfinite(c.float()).all() for c in calls):
        raise AssertionError("non-finite logits")
    log(f"[lm] first request's tokens {done[0].output.tolist()}")
    if cfg.moe:
        # The drops, from the same serve again, untimed, with its plans kept.
        del wave_caches, calls, snapshots
        server._prefill, server._decode = prefill, decode
        with RouteTap() as routes:
            again = server.serve([Request(i, p, LM_NEW_TOKENS) for i, p in enumerate(prompts)])
        same = all(np.array_equal(a.output, b.output) for a, b in zip(done, again))
        log(f"[lm] {cfg.name} served again with its routings kept (untimed): the same tokens "
            f"as the timed serve: {same}")
        moe_drops(torch, cfg, routes.calls, kinds.count("a"), prefills)
        del routes
        moe_consistency(torch, np, cfg, server.params, prompts, device)
        return launches
    bounds = BOUNDS[cfg.name]
    worst, worst_state = kv_cache_check(torch, np, server, prefill, waves, calls, wave_caches,
                                        snapshots, bounds)
    log(f"[lm] {cfg.name} cache consistency: worst |diff| / max |logit| {worst:.5f} "
        f"(bound {bounds['logits']}); worst cache |diff| / max |entry|: "
        f"{fmt_diff(worst_state, bounds)}")
    del wave_caches, calls, snapshots
    cache_mutation(torch, np, server, prefill, decode, waves[0], set(kinds), bounds)
    if "s" in kinds:
        for plen, total, rec in slstm_share(torch, np, prefill, server.params, waves, device):
            log(f"[lm] {cfg.name} prefill of {plen} positions: {total:.3f} s, of which the "
                f"{kinds.count('s')} sLSTM loops {rec:.3f} s ({rec / total * 100:.2f}%; "
                f"{rec / kinds.count('s') / plen * 1e6:.2f} us per step)")
    return launches


# --- LM training ([train]) ----------------------------------------------------------
#: Phase (b): qwen3-1.7b at full width and depth, batch x seq from TokenStream,
#: AdamW with float32 moments, remat per block; the lr follows cosine_warmup
#: over TRAIN_STEPS with TRAIN_WARMUP warm-up steps, so both of its pieces run.
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2, 4, 2048, 3e-4
#: Phase (c): the restart drill at full width and LM_LAYERS' depth, crashed
#: at each step of DRILL_FAIL_AT: at step 1, before the first checkpoint (every
#: DRILL_CKPT_EVERY steps), it starts again from the seeded state; at step 3
#: it resumes from step 2's checkpoint, loaded into the live state in place.
DRILL_STEPS, DRILL_CKPT_EVERY, DRILL_BATCH, DRILL_SEQ = 4, 2, 2, 512
DRILL_FAIL_AT = (1, 3)


def train_grad_checks(torch, cfgs: dict, dev) -> float:
    """Phase (a): each autograd-wrapped route on the card with seeded inputs
    and one fixed upstream gradient: the forward within the kernel's
    tolerance of the plain forward (and, without the mask, within
    ``SCALED_TOL`` of its scale), every input gradient bit-equal to the
    plain forward + backward() (``kernels.grad_check``); one launch (scan)
    each. K2 at qwen3-1.7b's training shape, at zamba2-7b's D 112, at MLA's
    latents (D 288 and 576, v = k), non-causal at seamless's cross-attention
    (D 64, 2,048 queries over 1,024 frames); K3's first route at zamba2's mixer
    shape (one batch), its wide route at the xLSTM's (P 513, N 512, chunk
    512) at a small S, and the 3-D form. Returns the largest forward error
    of each kernel by its name in the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grad_check
    from repro_torch.kernels.flash_attention import bench as fa_bench
    from repro_torch.kernels.ssm_scan import bench as ssd_bench
    from repro_torch.models import mamba2, xlstm

    gen = torch.Generator().manual_seed(27)
    rnd = lambda *shape, dt=torch.float32: torch.randn(*shape, generator=gen).to(dev, dt)
    bf16 = torch.bfloat16
    qwen, zamba, mla, ds, xl = (cfgs[a] for a in (LM_ARCH, HYBRID_ARCH, MLA_ARCH, MOE_MLA_ARCH,
                                                  RECURRENT_ARCH))
    seamless = get_config(ENCDEC_ARCH)
    flash_cases = [
        ("qwen3 training shape", (TRAIN_BATCH, qwen.num_heads, qwen.num_kv_heads, TRAIN_SEQ,
                                  qwen.resolved_head_dim), None, False),
        ("D 112", (1, zamba.num_heads, zamba.num_kv_heads, TRAIN_SEQ, zamba.resolved_head_dim),
         None, False),
        ("D 288, v = k", (1, mla.num_heads, 1, TRAIN_SEQ, mla.kv_lora_rank + mla.qk_rope_dim),
         MLA_SCALE, True),
        ("D 576, v = k", (1, ds.num_heads, 1, TRAIN_SEQ, ds.kv_lora_rank + ds.qk_rope_dim),
         DEEPSEEK_SCALE, True)]
    # (name, (B, Hq, Hkv, Sq, D), sm_scale, v is k[, Skv, causal]): seamless's
    # cross-attention in training, non-causal over half as many source frames
    flash_cases.append(("D 64 non-causal, seamless's cross-attention",
                        (ENCDEC_TRAIN_BATCH, seamless.num_heads, seamless.num_kv_heads,
                         ENCDEC_TRAIN_SEQ, seamless.resolved_head_dim), None, False,
                        ENCDEC_TRAIN_SEQ // 2, False))
    worst = {"flash_attention": 0.0, "ssd_scan": 0.0, "ssd_scan_wide": 0.0}
    for name, (b, hq, hkv, s, d), scale, v_is_k, *rest in flash_cases:
        skv, causal = rest or (s, True)
        q, k, v = (rnd(b, hq, s, d, dt=bf16), rnd(b, hkv, skv, d, dt=bf16),
                   rnd(b, hkv, skv, d, dt=bf16))
        case = grad_check.flash_case(q, k, k if v_is_k else v, rnd(b, hq, s, d, dt=bf16),
                                     causal=causal, sm_scale=scale)
        err = case.forward_err()
        tol = FLASH_TOL["bfloat16"]
        rel = fa_bench.scaled_errors(case.outputs[0], case.plain_outputs[0])
        if case.launches != 1 or not torch.allclose(case.outputs[0].float(),
                                                    case.plain_outputs[0].float(),
                                                    atol=tol, rtol=tol) or \
                (not causal and any(r > lim for r, lim in
                                    zip(rel, fa_bench.SCALED_TOL["bfloat16"]))):
            raise AssertionError(f"[train] K2 {name}: forward differs by {err:.3e}, scaled "
                                 f"(max, mean) {rel} ({case.launches} launches)")
        if not case.grads_equal():
            raise AssertionError(f"[train] K2 {name}: the wrapper's gradients are not the plain "
                                 "version's bit for bit")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        log(f"[train] grad check K2 {name} {(b, hq, hkv, s, skv, d)} bf16: forward max abs err "
            f"{err:.3e}, scaled (max, mean) {rel[0]:.3e}, {rel[1]:.3e}, {len(case.grads)} input "
            f"gradients bit-equal to the plain version's")
        del q, k, v, case
        torch.cuda.empty_cache()
    _, heads, head_dim, state = mamba2._dims(zamba)
    _, xl_heads, xl_p = xlstm._mdims(xl)
    scan_cases = [
        ("ssd_scan", "first route, zamba2's mixer shape",
         ssd_bench.heads_inputs(torch, 1, heads, 1, TRAIN_SEQ, head_dim, state, seed=271,
                                device=dev), zamba.ssm_chunk),
        ("ssd_scan_wide", "wide route, the xLSTM's scan at S 600",
         ssd_bench.mlstm_inputs(torch, 1, xl_heads, 600, xl_p + 1, xl_p, seed=272,
                                device=dev), xl.ssm_chunk),
        ("ssd_scan", "3-D form", tuple(t[0] for t in ssd_bench.heads_inputs(
            torch, 1, 16, 16, 300, 64, 32, seed=273, device=dev)), 128)]
    for kernel, name, args, chunk in scan_cases:
        y_shape = args[0].shape
        st_shape = (*args[0].shape[:-2], args[2].shape[-1], args[0].shape[-1])
        for with_state in (False, True):
            case = grad_check.scan_case(*args, chunk, rnd(*y_shape),
                                        rnd(*st_shape) if with_state else None)
            err = case.forward_err()
            close = all(torch.allclose(a, b, atol=SSD_TOL, rtol=SSD_TOL)
                        for a, b in zip(case.outputs, case.plain_outputs))
            if case.launches != 1 or not close:
                raise AssertionError(f"[train] K3 {name}: forward differs by {err:.3e} "
                                     f"({case.launches} scans)")
            if not case.grads_equal():
                raise AssertionError(f"[train] K3 {name}: the wrapper's gradients are not the "
                                     "plain version's bit for bit")
            worst[kernel] = max(worst[kernel], err)
            log(f"[train] grad check K3 {name} {tuple(y_shape)}, upstream gradient on y"
                f"{' and the final state' if with_state else ''}: forward max abs err "
                f"{err:.3e}, 4 input gradients bit-equal to the plain version's")
            del case
        del args
        torch.cuda.empty_cache()
    return worst


def train_steps(torch, np, counters, cfg, dev) -> dict:
    """Phase (b): ``make_train_step`` on qwen3-1.7b at full width and depth,
    every launch count set to 0 just before and read just after."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import zoo
    from repro_torch.optim.optimizers import AdamWConfig, init_opt_state
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.trainer import make_train_step

    t0 = time.perf_counter()
    params = zoo.init_params(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    opt = init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, {cfg.dtype} params ({n_params}), "
        f"{opt_cfg.moment_dtype} AdamW moments, remat {cfg.remat}; state made in "
        f"{time.perf_counter() - t0:.2f} s")
    schedule = cosine_warmup(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg, schedule)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_per_shard=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.LAUNCHES = 0
    walls, metrics = [], []
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in stream.batch_at(step).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, step)
        m = {k: float(v) for k, v in m.items()}
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        log(f"[train] step {step}: loss {m['loss']:.6f}, grad norm {m['gnorm']:.6f}, lr "
            f"{m['lr']:.9g}, {walls[-1] * 1e3:.1f} ms")
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    kinds = block_kinds(cfg)
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = 2 * kinds.count("a") * TRAIN_STEPS   # forward + remat recompute
    if launches != expected:
        raise AssertionError(f"[train] launches {launches}, expected {expected}")
    for step, m in enumerate(metrics):
        if not (np.isfinite(m["loss"]) and np.isfinite(m["gnorm"])):
            raise AssertionError(f"[train] step {step}: non-finite loss or gradient norm {m}")
        if m["lr"] != float(schedule(step)):
            raise AssertionError(f"[train] step {step}: lr {m['lr']} is not cosine_warmup's")
    if int(opt["count"]) != TRAIN_STEPS:
        raise AssertionError(f"[train] the optimizer counted {int(opt['count'])} steps")
    if not all(torch.isfinite(t.float()).all() for t in leaves(params) + leaves(opt["m"])):
        raise AssertionError("[train] non-finite parameters or moments")
    step_ms = float(np.median(walls[1:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {cfg.name} batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: step {step_ms:.1f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}; step 0 {walls[0] * 1e3:.1f} ms), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, peak device memory {peak:.3f} GiB; "
        f"launches {launches}")
    return {"launches": launches, "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gib": peak}


def restart_drill(torch, counters, cfg, dev) -> dict:
    """Phase (c): ``Trainer.run_with_restarts`` crashed at each step of
    DRILL_FAIL_AT must end on the bits of an uninterrupted ``Trainer.run``
    from the same seeded state, params and moments, and a restore must load
    into the live state (the card's allocated bytes grow by less than one
    state); checkpoints in a temporary directory."""
    import shutil
    import tempfile

    from repro_torch.optim.optimizers import leaves as opt_leaves
    from repro_torch.runtime.faults import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    log(f"[train] restart drill checkpoints in a temporary directory, "
        f"{shutil.disk_usage(root).free / 2**30:.1f} GiB free there")
    try:
        tcfg = lambda name, every: TrainerConfig(
            steps=DRILL_STEPS, ckpt_every=every, batch=DRILL_BATCH, seq_len=DRILL_SEQ,
            ckpt_dir=os.path.join(root, name))
        for mod in counters.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        clean = Trainer(cfg, tcfg("clean", DRILL_STEPS), device=dev).run()
        clean_state = [t.detach().cpu() for t in opt_leaves(clean["state"])]
        del clean
        shutil.rmtree(os.path.join(root, "clean"))
        t_clean = time.perf_counter() - t0

        trainer = Trainer(cfg, tcfg("drill", DRILL_CKPT_EVERY),
                          injector=FailureInjector(fail_at_steps=DRILL_FAIL_AT), device=dev)
        saves, restores = [], []
        save, restore = trainer.save, trainer.try_restore

        def timed_save(state, step):
            t = time.perf_counter()
            save(state, step)
            saves.append(time.perf_counter() - t)

        def timed_restore(state):
            torch.cuda.synchronize()
            mem, t = torch.cuda.memory_allocated(), time.perf_counter()
            step = restore(state)
            torch.cuda.synchronize()
            restores.append((time.perf_counter() - t, step, torch.cuda.memory_allocated() - mem))
            return step

        trainer.save, trainer.try_restore = timed_save, timed_restore
        t0 = time.perf_counter()
        out = trainer.run_with_restarts()
        t_drill = time.perf_counter() - t0
        launches = {name: mod.LAUNCHES for name, mod in counters.items()}
        step_dir = os.path.join(root, "drill", f"step_{DRILL_CKPT_EVERY:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        drill_state = opt_leaves(out["state"])
        state_bytes = sum(t.numel() * t.element_size() for t in drill_state)
        same = len(drill_state) == len(clean_state) and all(
            torch.equal(a.cpu(), b) for a, b in zip(drill_state, clean_state))
        steps_run = [m["step"] for m in out["metrics"]]
        log(f"[train] restart drill {cfg.name} at {cfg.num_layers} layers, batch {DRILL_BATCH} x "
            f"seq {DRILL_SEQ}: crashes at steps {DRILL_FAIL_AT}, {out['restarts']} restart(s), "
            f"steps run {steps_run}; a checkpoint {ckpt_bytes} bytes, saves "
            f"{[round(t, 3) for t in saves]} s, restores "
            f"{[(round(t, 3), step, grew) for t, step, grew in restores]} (s, step, allocated "
            f"bytes added; the state {state_bytes} B); the drill {t_drill:.1f} s, "
            f"the uninterrupted run {t_clean:.1f} s; params and moments bit-equal: {same}")
        kinds = block_kinds(cfg)
        expected = {name: 0 for name in counters}
        expected["flash_attention"] = 2 * kinds.count("a") * (DRILL_STEPS + len(steps_run))
        if launches != expected:
            raise AssertionError(f"[train] drill launches {launches}, expected {expected}")
        if any(grew >= state_bytes for _, _, grew in restores):
            raise AssertionError(f"[train] a restore allocated a second state: {restores}")
        if [step for _, step, _ in restores] != [None, None, DRILL_CKPT_EVERY]:
            raise AssertionError(f"[train] the drill restored {restores}, expected no checkpoint "
                                 f"twice, then step {DRILL_CKPT_EVERY}'s")
        if out["restarts"] != len(DRILL_FAIL_AT) or out["final_step"] != DRILL_STEPS or not same:
            raise AssertionError("[train] the restarted run did not end on the uninterrupted "
                                 "run's bits")
        return {"launches": launches, "ckpt_bytes": ckpt_bytes, "saves": saves,
                "restores": restores}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_phase(torch, np, counters, cfgs: dict, dev) -> dict:
    """The [train] phase: (a) the autograd wrappers' gradient checks, (b)
    qwen3-1.7b's steps at full width and depth, (c) the restart drill at
    LM_LAYERS' depth. Returns the launches of (b) and (c) and the numbers
    for the kernels line."""
    from repro_torch.configs import get_config

    grad_err = train_grad_checks(torch, cfgs, dev)
    torch.cuda.empty_cache()
    steps = train_steps(torch, np, counters, get_config(LM_ARCH), dev)
    torch.cuda.empty_cache()
    drill = restart_drill(torch, counters, cfgs[LM_ARCH], dev)
    torch.cuda.empty_cache()
    return {"grad_err": grad_err, "steps": steps, "drill": drill}


# --- encoder-decoder models and front ends ([encdec]) ----------------------------

def vq_prompts(np, vocab: int):
    """chameleon's traffic: ``lm_prompts``' lengths (numpy seed 0), each
    prompt ``frontend.vq_token_stream`` of fold_in(PRNGKey(0), i): its first
    half VQ image codes, the rest text ids."""
    from repro_torch import prng
    from repro_torch.models import frontend

    lens = np.random.default_rng(0).integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1,
                                             LM_REQUESTS)
    return [frontend.vq_token_stream(prng.fold_in(prng.PRNGKey(0), i), 1, int(n), vocab,
                                     device="cpu")[0].numpy().astype(np.int32)
            for i, n in enumerate(lens)]


def kv_rel_diff(served, fresh, rows: int) -> float:
    """The largest |served - fresh| of each decoder layer's self k and v at
    positions [0, rows), over that tensor's largest |fresh| entry."""
    worst = 0.0
    for got_layer, want_layer in zip(served, fresh):
        for name in ("k", "v"):
            want = want_layer["self"][name][:, :, :rows].float()
            got = got_layer["self"][name][:, :, :rows].float()
            worst = max(worst, (got - want).abs().max().item() / want.abs().max().item())
    return worst


def encdec_serve(torch, np, counters, cfg, dev) -> dict:
    """[encdec] (b): seamless at full width and depth through
    ``zoo.prefill_fn`` / ``zoo.decode_fn`` (the reference has no
    encoder-decoder server): ENCDEC_WAVES' waves, LM_NEW_TOKENS greedy
    tokens each, every launch count set to 0 just before and read just
    after. K2 must launch once per encoder layer, decoder self-attention and
    cross-attention in each prefill and never in a decode step. Then, for
    each wave and n in KV_CHECK_STEPS, a fresh prefill over the wave's
    frames and prompt plus its first n generated tokens must give decode
    step n's logits and every layer's self k/v within BOUNDS, and every
    layer's cross k/v bit for bit (decode reads the cross cache and never
    writes it)."""
    from repro_torch.models import frontend, zoo

    if ENCDEC_WAVES[0][1] != zoo.CROSS_SRC_LEN:
        raise AssertionError("the first wave's source is not zoo.CROSS_SRC_LEN frames")
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[encdec] {cfg.name}: {cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, d "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: {n_params} parameters (seed 0; "
        f"the config's param_count() {cfg.param_count()}, which leaves out the decoder's "
        f"cross-attention norms and the two final norms) in {time.perf_counter() - t0:.2f} s")
    prefill, decode = zoo.prefill_fn(cfg, LM_MAX_LEN), zoo.decode_fn(cfg)
    rng = np.random.default_rng(0)
    waves = [(frontend.audio_frames(w, LM_SLOTS, src, cfg.d_model, device=dev),
              torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_SLOTS, plen)), device=dev))
             for w, (plen, src) in enumerate(ENCDEC_WAVES)]
    fa = counters["flash_attention"]
    per_prefill = cfg.enc_layers + 2 * cfg.dec_layers
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.LAUNCHES = 0
    served, prefill_s, decode_ms = [], [], []
    for frames, toks in waves:
        plen = toks.shape[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = fa.LAUNCHES
        logits, caches = prefill(params, {"frames": frames, "tokens": toks})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        if fa.LAUNCHES - before != per_prefill:
            raise AssertionError(f"[encdec] a prefill launched K2 {fa.LAUNCHES - before} "
                                 f"times, expected {per_prefill}")
        calls, cur = [logits], logits.argmax(-1)[:, None]
        gen = [cur]
        t0 = time.perf_counter()
        for step in range(LM_NEW_TOKENS - 1):
            logits, caches = decode(params, caches, cur, plen + step)
            cur = logits.argmax(-1)[:, None]
            calls.append(logits)
            gen.append(cur)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) / (LM_NEW_TOKENS - 1) * 1e3)
        served.append({"calls": calls, "caches": caches, "gen": torch.cat(gen, dim=1)})
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = per_prefill * len(waves)
    for (frames, toks), s_ms, p_s in zip(waves, decode_ms, prefill_s):
        log(f"[encdec] {cfg.name} wave of {LM_SLOTS} x {toks.shape[1]} prompt tokens over "
            f"{frames.shape[1]} frames: prefill {p_s:.4f} s, decode {s_ms:.3f} ms/step "
            f"({LM_NEW_TOKENS - 1} steps)")
    log(f"[encdec] {cfg.name} peak device memory {peak:.3f} GiB; launches {launches}")
    if launches != expected:
        raise AssertionError(f"[encdec] launches {launches}, expected {expected}")
    if not all(torch.isfinite(c.float()).all() for sv in served for c in sv["calls"]):
        raise AssertionError("[encdec] non-finite logits")
    bounds = BOUNDS[cfg.name]
    worst = {"logits": 0.0, "kv": 0.0}
    warm_s = {}                          # each wave's first fresh prefill, timed
    for w, ((frames, toks), sv) in enumerate(zip(waves, served)):
        plen = toks.shape[1]
        seq = torch.cat([toks, sv["gen"]], dim=1)
        for n in KV_CHECK_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh, fresh_caches = prefill(params, {"frames": frames, "tokens": seq[:, :plen + n]})
            torch.cuda.synchronize()
            warm_s.setdefault(w, time.perf_counter() - t0)
            step = sv["calls"][n].float()
            fresh = fresh.float()
            diff, scale = (fresh - step).abs().max().item(), step.abs().max().item()
            kv = kv_rel_diff(sv["caches"], fresh_caches, plen + n)
            cross_equal = all(torch.equal(a["cross"][name], b["cross"][name])
                              for a, b in zip(sv["caches"], fresh_caches) for name in ("k", "v"))
            log(f"[encdec] wave {w} step {n}: fresh prefill vs decode max |diff| {diff:.4f} (max "
                f"|logit| {scale:.2f}; {diff / scale:.5f}, bound {bounds['logits']}); self k/v "
                f"over positions 0..{plen + n - 1} {kv:.5f} of the largest entry (bound "
                f"{bounds['kv']}); cross k/v bit-equal: {cross_equal}")
            if not diff <= bounds["logits"] * scale:
                raise AssertionError(f"[encdec] wave {w} step {n}: decode logits differ by "
                                     f"{diff} > {bounds['logits']} x {scale}")
            if not kv <= bounds["kv"]:
                raise AssertionError(f"[encdec] wave {w} step {n}: self k/v differ by {kv}")
            if not cross_equal:
                raise AssertionError(f"[encdec] wave {w} step {n}: the served cross cache is "
                                     "not the fresh prefill's bit for bit")
            top2 = step.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > diff
            if not torch.equal(fresh.argmax(-1)[sure], step.argmax(-1)[sure]):
                raise AssertionError(f"[encdec] wave {w} step {n}: argmax differs where the "
                                     f"top-2 margin exceeds {diff}")
            worst = {"logits": max(worst["logits"], diff / scale), "kv": max(worst["kv"], kv)}
            del fresh_caches
    log(f"[encdec] {cfg.name} cache consistency: worst |diff| / max |logit| "
        f"{worst['logits']:.5f}, self k/v {worst['kv']:.5f}; cross caches bit-equal; first "
        f"request's tokens {served[0]['gen'][0].tolist()}")
    log(f"[encdec] {cfg.name} a warm prefill (each wave's first fresh prefill, 1 token "
        f"longer): {[round(warm_s[w], 4) for w in range(len(waves))]} s; the served ones "
        f"{[round(t, 4) for t in prefill_s]} s")
    return {"launches": launches, "prefill_s": prefill_s, "decode_ms": decode_ms,
            "warm_prefill_s": [warm_s[w] for w in range(len(waves))], "peak_gib": peak,
            "worst": worst}


def encdec_train(torch, np, counters, cfg, dev) -> dict:
    """[encdec] (d): ENCDEC_TRAIN_STEPS ``Trainer`` steps of seamless at full
    width and ENCDEC_TRAIN_LAYERS + ENCDEC_TRAIN_LAYERS layers (frames from
    the Trainer's frames branch), every launch count set to 0 just before
    and read just after: losses and gradient norms finite, K2 twice per
    attention a step (the forward and the remat recompute; 3 attentions a
    decoder layer's pair, one an encoder layer's). The run writes no
    checkpoint (``[train]``'s drill times them)."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=ENCDEC_TRAIN_STEPS, ckpt_every=ENCDEC_TRAIN_STEPS,
                         batch=ENCDEC_TRAIN_BATCH, seq_len=ENCDEC_TRAIN_SEQ)
    trainer = Trainer(cfg, tcfg, device=dev)
    trainer.save = lambda state, step: None
    walls, step_fn = [], trainer.step_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    trainer.step_fn = timed
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    log(f"[encdec] train {cfg.name} at {cfg.enc_layers} + {cfg.dec_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} params "
        f"({sum(t.numel() for t in leaves(state['params']))}), float32 AdamW moments, remat "
        f"{cfg.remat}: state made in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.LAUNCHES = 0
    out = trainer.run(start_state=state)
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m, wall in zip(out["metrics"], walls):
        log(f"[encdec] train step {m['step']}: loss {m['loss']:.6f}, grad norm {m['gnorm']:.6f}, "
            f"lr {m['lr']:.9g}, {wall * 1e3:.1f} ms")
    tokens = ENCDEC_TRAIN_BATCH * ENCDEC_TRAIN_SEQ
    log(f"[encdec] train batch {ENCDEC_TRAIN_BATCH} x {ENCDEC_TRAIN_SEQ} target tokens over "
        f"{ENCDEC_TRAIN_SEQ // 2} frames: steps {[round(w * 1e3, 1) for w in walls]} ms "
        f"({tokens / walls[-1]:.1f} target tokens/s at the last), peak device memory "
        f"{peak:.3f} GiB; launches {launches}")
    expected = {name: 0 for name in counters}
    expected["flash_attention"] = 2 * (cfg.enc_layers + 2 * cfg.dec_layers) * ENCDEC_TRAIN_STEPS
    if launches != expected:
        raise AssertionError(f"[encdec] train launches {launches}, expected {expected}")
    if out["final_step"] != ENCDEC_TRAIN_STEPS or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["gnorm"]) for m in out["metrics"]):
        raise AssertionError(f"[encdec] train: {out['final_step']} steps, metrics "
                             f"{out['metrics']}")
    return {"launches": launches, "step_ms": [w * 1e3 for w in walls], "peak_gib": peak,
            "losses": [m["loss"] for m in out["metrics"]]}


def encdec_phase(torch, np, counters, cfgs: dict, cases: dict, dev) -> dict:
    """The [encdec] phase: (b) seamless serving at full width and depth, (c)
    chameleon at full width and LM_LAYERS' depth through ``lm_path`` with
    ``vq_prompts``, (d) seamless's Trainer steps, then K2's times at the
    phase's shapes (``cases``: name -> case). Returns each path's launches
    and the numbers for the kernels line."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    seamless, vlm = cfgs[ENCDEC_ARCH], cfgs[VLM_ARCH]
    serve = encdec_serve(torch, np, counters, seamless, dev)
    torch.cuda.empty_cache()
    vlm_launches = lm_path(torch, np, counters, vlm, vq_prompts(np, vlm.vocab_size), dev)
    torch.cuda.empty_cache()
    train = encdec_train(torch, np, counters, dataclasses.replace(
        seamless, enc_layers=ENCDEC_TRAIN_LAYERS, dec_layers=ENCDEC_TRAIN_LAYERS,
        num_layers=2 * ENCDEC_TRAIN_LAYERS), dev)
    torch.cuda.empty_cache()
    times = {name: flash_times(torch, fa_ops, fa_ref, case) for name, case in cases.items()}
    return {"serve": serve, "vlm_launches": vlm_launches, "train": train, "times": times}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels.chain_dot import ops as chain_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.sgns import ops
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan import wide as ssd_wide

    counters = {"sgns_lifetime": ops, "flash_attention": fa_ops, "ssd_scan": ssd_ops,
                "ssd_scan_wide": ssd_wide, "chain_dot": chain_ops}
    libs = [ops.LIBRARY, fa_ops.LIBRARY, ssd_ops.LIBRARY, ssd_wide.LIBRARY, chain_ops.LIBRARY]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_main = time.perf_counter()
    mark = lambda what: log(f"[elapsed] {what} done at {time.perf_counter() - t_main:.1f} s")
    # One worker process makes the host-only inputs while the card works.
    import concurrent.futures
    import multiprocessing

    host = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_paths(torch, np, dev, counters, libs, host, t_main, mark)
    finally:
        host.shutdown(wait=True, cancel_futures=True)


def run_paths(torch, np, dev, counters, libs, host, t_main, mark) -> int:
    """The phases of ``main`` (the module's docstring), ``host`` a worker
    pool for the host-only preparation."""
    from repro_torch.configs import get_config
    from repro_torch.configs.distger import GRAPH_PRESETS
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attention import bench as fa_bench
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.sgns import ops, ref
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan import ref as ssd_ref
    from repro_torch.kernels.ssm_scan import wide as ssd_wide

    yt_job = host.submit(host_graph, "yt-sim")
    fl_job = host.submit(host_graph, "fl-sim", churn=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build_all(libs)
    log(f"[build] {', '.join(lib.library_path().name for lib in libs)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line \
                    or "C75" in line:
                log(f"[build] {lib.name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    sass_check(fa_ops.LIBRARY, fa_ops.HEAD_DIMS)
    ssd_sass_check(ssd_ops.LIBRARY, ssd_wide.LIBRARY)

    # 2. kernels against their plain versions ----------------------------------
    sgns_err = 0.0
    for i, shape in enumerate([PAPER_SHAPE, *RAGGED_SHAPES]):
        ctx, out, neg, valid = sgns_inputs(torch, **shape, seed=i, device=dev,
                                           invalid=i > 0)
        got = ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, shape["window"])
        want = ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, shape["window"])
        torch.cuda.synchronize()
        err = sgns_compare(torch, got, want, f"sgns_lifetime {shape}")
        sgns_err = max(sgns_err, err)
        log(f"[check] sgns_lifetime {shape}: max abs err {err:.3e}")

    lm_cfg, hy_cfg, rec_cfg, mla_cfg, ds_cfg, moe_cfg, vlm_cfg = (
        dataclasses.replace(get_config(a), num_layers=LM_LAYERS[a]) for a in (
            LM_ARCH, HYBRID_ARCH, RECURRENT_ARCH, MLA_ARCH, MOE_MLA_ARCH, MOE_ARCH, VLM_ARCH))
    prompts = lm_prompts(np, lm_cfg.vocab_size)
    hy_prompts = lm_prompts(np, hy_cfg.vocab_size)
    rec_prompts = lm_prompts(np, rec_cfg.vocab_size)
    mla_prompts = lm_prompts(np, mla_cfg.vocab_size)
    ds_prompts = lm_prompts(np, ds_cfg.vocab_size)
    moe_prompts = lm_prompts(np, moe_cfg.vocab_size)
    s_prefill = max(len(p) for p in prompts)     # the longest padded prompt
    prefill_case = (LM_SLOTS, lm_cfg.num_heads, lm_cfg.num_kv_heads, s_prefill, s_prefill,
                    lm_cfg.resolved_head_dim, True, 0, "bfloat16")
    hy_prefill_case = (LM_SLOTS, hy_cfg.num_heads, hy_cfg.num_kv_heads, s_prefill, s_prefill,
                       hy_cfg.resolved_head_dim, True, 0, "bfloat16")
    latent = {}          # MLA model -> its prefill case on the latent (one KV head, v = k)
    for cfg, scale in ((mla_cfg, MLA_SCALE), (ds_cfg, DEEPSEEK_SCALE)):
        d = cfg.kv_lora_rank + cfg.qk_rope_dim
        if (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 != scale or \
                fa_bench.LATENTS[d] != (cfg.kv_lora_rank, scale):
            raise AssertionError(f"{cfg.name}'s latent head dim or scale is not MLA_FLASH_CASES'")
        latent[cfg.name] = (LM_SLOTS, cfg.num_heads, 1, s_prefill, s_prefill, d, True, 0,
                            "bfloat16")
    mla_prefill_case, ds_prefill_case = latent[MLA_ARCH], latent[MOE_MLA_ARCH]
    moe_prefill_case = (LM_SLOTS, moe_cfg.num_heads, moe_cfg.num_kv_heads, s_prefill, s_prefill,
                        moe_cfg.resolved_head_dim, True, 0, "bfloat16")
    vlm_prefill_case = (LM_SLOTS, vlm_cfg.num_heads, vlm_cfg.num_kv_heads, s_prefill, s_prefill,
                        vlm_cfg.resolved_head_dim, True, 0, "bfloat16")
    ed_cfg = get_config(ENCDEC_ARCH)
    ed_cases = {f"{ENCDEC_ARCH} encoder": ENCDEC_FLASH_CASES[0],
                f"{ENCDEC_ARCH} cross": ENCDEC_FLASH_CASES[1], VLM_ARCH: vlm_prefill_case}
    if ENCDEC_FLASH_CASES[0][1:6] != (ed_cfg.num_heads, ed_cfg.num_kv_heads, ENCDEC_WAVES[0][1],
                                      ENCDEC_WAVES[0][1], ed_cfg.resolved_head_dim) or \
            ENCDEC_FLASH_CASES[1][3:5] != (ENCDEC_WAVES[0][0], ENCDEC_WAVES[0][1]):
        raise AssertionError("ENCDEC_FLASH_CASES are not seamless's first wave's shapes")
    mla_cases = [(*c[:8], dt, c[8]) for c in
                 [(*case[:8], v) for case in latent.values() for v in ("own", "padded", "k")]
                 + MLA_FLASH_CASES for dt in ("float32", "bfloat16")]
    flash_err = 0.0
    checks = [(case, None, "own") for case in [*FLASH_CASES, prefill_case, hy_prefill_case,
                                                moe_prefill_case, *ENCDEC_FLASH_CASES,
                                                vlm_prefill_case]] + \
        [(case[:9], fa_bench.LATENTS[case[5]][1], case[9]) for case in mla_cases]
    for i, (case, scale, v_mode) in enumerate(checks):
        scaled = case in ENCDEC_FLASH_CASES and not case[6]
        err, chunked, rel = flash_check(torch, fa_ops, fa_ref, case, seed=100 + i,
                                        sm_scale=scale, v_mode=v_mode, scaled=scaled)
        flash_err = max(flash_err, err)
        log(f"[check] flash_attention {case}"
            + (f" sm_scale {scale:.6f} v {v_mode}" if scale else "")
            + f": max abs err {err:.3e} against mha_reference"
            + (f", {chunked:.3e} against mha_chunked" if chunked is not None else "")
            + f"; scaled (max, mean) {rel[0]:.3e}, {rel[1]:.3e}"
            + (f" within {fa_bench.SCALED_TOL[case[8]]}" if scaled else ""))
        torch.cuda.empty_cache()

    hy_d_in = hy_cfg.ssm_expand * hy_cfg.d_model
    hy_heads = hy_d_in // hy_cfg.ssm_head_dim
    ssd_prefill_case = (LM_SLOTS * hy_heads, s_prefill, hy_cfg.ssm_head_dim, hy_cfg.ssm_state,
                        hy_cfg.ssm_chunk)
    ssd_main_case = (LM_SLOTS, hy_heads, 1, s_prefill, hy_cfg.ssm_head_dim, hy_cfg.ssm_state,
                     hy_cfg.ssm_chunk)      # the mixer's form of zamba2's prefill wave
    ssd_err = 0.0
    for i, case in enumerate([*SSD_CASES, ssd_prefill_case, *SSD_GROUP_CASES, ssd_main_case]):
        model_decay = case == ssd_prefill_case or len(case) == 7
        err = ssd_check(torch, ssd_ops, ssd_ref, case, seed=200 + i, device=dev,
                        model_decay=model_decay)
        ssd_err = max(ssd_err, err)
        log(f"[check] ssd_scan {case}{' (model decay)' if model_decay else ''}: "
            f"max abs err {err:.3e}")
    torch.cuda.empty_cache()

    rec_heads = rec_cfg.ssm_heads
    rec_p = rec_cfg.ssm_expand * rec_cfg.d_model // rec_heads
    wide_main_case = (LM_SLOTS, rec_heads, s_prefill, rec_p + 1, rec_p, rec_cfg.ssm_chunk)
    wide_err = 0.0
    for i, case in enumerate([wide_main_case, *WIDE_MLSTM_CASES, *SSD_CASES]):
        err = wide_check(torch, ssd_ops, case, seed=300 + i, device=dev)
        wide_err = max(wide_err, err)
        log(f"[check] ssd_scan wide route {case}"
            f"{' (mLSTM scale)' if len(case) == 6 else ' (model decay)'}: max abs err {err:.3e}")
        torch.cuda.empty_cache()

    mark("build and checks")

    # 3. the embedding path: k = 2 (the paper's regime), then k = 1 ---------------
    preset = GRAPH_PRESETS["yt-sim"]
    t0 = time.perf_counter()
    yt = yt_job.result()
    graph = device_graph(torch, yt, dev)
    torch.cuda.synchronize()
    log(f"[main] {preset.name}: |V|={graph.num_nodes} arcs={graph.num_edges}; the graph built "
        f"on the host in a worker process in {yt['graph_s']:.2f} s, waited for and moved to "
        f"the card in {time.perf_counter() - t0:.2f} s")
    emb = {k: embedding_path(torch, np, counters, graph, k, dev) for k in (2, 1)}
    phi_in = torch.stack([emb[2].pop("phi_in"), emb[1].pop("phi_in")])      # (2, N, d)
    phi_out = torch.stack([emb[2].pop("phi_out"), emb[1].pop("phi_out")])
    want = (phi_in[0].cpu(), phi_out[0].cpu())      # [main k=2]'s, for [durable]
    serve = serve_phase(torch, np, counters, phi_in, dev)
    torch.cuda.empty_cache()
    mark("[serve]")
    sgns = sgns_main_path(torch, np, phi_in, phi_out, emb[2].pop("corpus"), dev)
    sgns_err = max(sgns_err, sgns["max_abs_err"])
    del phi_in, phi_out, emb[1]["corpus"]
    torch.cuda.empty_cache()
    mark("[main]")
    mpgp2 = emb[2].pop("assignment")                # [main k=2]'s MPGP partition
    cm = graph.with_edge_cm().edge_cm.cpu().numpy()  # [walk]'s k = 4 MPGP, made meanwhile
    k4_job = host.submit(host_mpgp, yt["indptr"], yt["indices"], cm, 4)
    spmd_dir = tempfile.mkdtemp(prefix="chip_smoke_spmd_")     # [spmd]'s ranks load these
    # MPGP's k = 2 partition, and the hash partition (node mod k, as
    # mpgp.hash_partition), under which walkers cross ranks.
    spmd_parts = {"part": mpgp2, "hash": (np.arange(len(mpgp2)) % 2).astype(mpgp2.dtype)}
    for name, arr in (("indptr", yt["indptr"]), ("indices", yt["indices"]), ("edge_cm", cm),
                      *spmd_parts.items()):
        np.save(os.path.join(spmd_dir, f"{name}.npy"), arr)
    del yt, cm
    durable = durable_phase(torch, np, counters, graph, mpgp2, want, dev)
    del want
    torch.cuda.empty_cache()
    mark("[durable]")
    mpgp4, mpgp4_s = k4_job.result()
    log(f"[walk] mpgp k=4: partition {mpgp4_s:.2f} s in a worker process during [durable], "
        f"nodes per part {np.bincount(mpgp4, minlength=4).tolist()}")
    stacked = walk_phase(torch, np, graph, dev, {(2, "mpgp"): mpgp2, (4, "mpgp"): mpgp4})
    mark("[walk]")
    try:
        cm = torch.from_numpy(np.load(os.path.join(spmd_dir, "edge_cm.npy"))).to(dev)
        spmd = spmd_phase(torch, np, counters, spmd_dir, dataclasses.replace(graph, edge_cm=cm),
                          spmd_parts, stacked, lm_cfg, dev)
        del cm
    finally:
        shutil.rmtree(spmd_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("[spmd]")
    del graph
    torch.cuda.empty_cache()
    refresh = refresh_phase(torch, np, counters, dev, fl_job.result())
    torch.cuda.empty_cache()
    mark("[refresh]")

    # 4. the dense LM path -------------------------------------------------------
    launches = {LM_ARCH: lm_path(torch, np, counters, lm_cfg, prompts)}
    mark(LM_ARCH)
    torch.cuda.empty_cache()
    flash_shapes = {LM_ARCH: flash_times(torch, fa_ops, fa_ref, prefill_case)}

    # 5. the hybrid LM path --------------------------------------------------------
    launches[HYBRID_ARCH] = lm_path(torch, np, counters, hy_cfg, hy_prompts)
    mark(HYBRID_ARCH)
    torch.cuda.empty_cache()
    flash_shapes[HYBRID_ARCH] = flash_times(torch, fa_ops, fa_ref, hy_prefill_case)
    ssd = ssd_times(torch, ssd_ops, ssd_main_case, dev)

    # 6. the recurrent LM path -------------------------------------------------------
    launches[RECURRENT_ARCH] = lm_path(torch, np, counters, rec_cfg, rec_prompts)
    mark(RECURRENT_ARCH)
    torch.cuda.empty_cache()
    wide_t = wide_times(torch, ssd_ops, wide_main_case, dev)

    # 7. the MLA LM path ----------------------------------------------------------------
    launches[MLA_ARCH] = lm_path(torch, np, counters, mla_cfg, mla_prompts)
    mark(MLA_ARCH)
    torch.cuda.empty_cache()
    flash_shapes[MLA_ARCH] = flash_times(torch, fa_ops, fa_ref, mla_prefill_case,
                                         sm_scale=MLA_SCALE, v_mode="k")

    # 8. the MoE + MLA LM path ----------------------------------------------------------
    launches[MOE_MLA_ARCH] = lm_path(torch, np, counters, ds_cfg, ds_prompts)
    mark(MOE_MLA_ARCH)
    torch.cuda.empty_cache()
    flash_shapes[MOE_MLA_ARCH] = flash_times(torch, fa_ops, fa_ref, ds_prefill_case,
                                             sm_scale=DEEPSEEK_SCALE, v_mode="k")

    # 9. the plain MoE LM path ----------------------------------------------------------
    launches[MOE_ARCH] = lm_path(torch, np, counters, moe_cfg, moe_prompts)
    mark(MOE_ARCH)
    torch.cuda.empty_cache()
    flash_shapes[MOE_ARCH] = flash_times(torch, fa_ops, fa_ref, moe_prefill_case)

    # 10. LM training ------------------------------------------------------------------
    train = train_phase(torch, np, counters, {
        LM_ARCH: lm_cfg, HYBRID_ARCH: hy_cfg, RECURRENT_ARCH: rec_cfg, MLA_ARCH: mla_cfg,
        MOE_MLA_ARCH: ds_cfg}, dev)
    mark("[train]")
    launches[f"{LM_ARCH} train"] = train["steps"]["launches"]
    launches[f"{LM_ARCH} restart drill"] = train["drill"]["launches"]
    launches[f"{LM_ARCH} [spmd] step builder"] = spmd["step"]["launches"]

    # 11. encoder-decoder models and front ends ----------------------------------------
    encdec = encdec_phase(torch, np, counters, {ENCDEC_ARCH: ed_cfg, VLM_ARCH: vlm_cfg},
                          ed_cases, dev)
    mark("[encdec]")
    launches[ENCDEC_ARCH] = encdec["serve"]["launches"]
    launches[VLM_ARCH] = encdec["vlm_launches"]
    launches[f"{ENCDEC_ARCH} train"] = encdec["train"]["launches"]
    flash_shapes.update(encdec["times"])
    flash_err = max(flash_err, train["grad_err"]["flash_attention"])
    total = {name: sum(path[name] for path in launches.values()) for name in counters}
    total["sgns_lifetime"] += emb[2]["launches"] + emb[1]["launches"] \
        + durable["launches"] + sum(refresh["launches"].values())
    total["chain_dot"] += serve["launches"] + refresh["serve_launches"]
    log(f"[main] launches by path: sgns_lifetime yt-sim k=2 {emb[2]['launches']}, k=1 "
        f"{emb[1]['launches']}, durable {durable['launches']}, {refresh['launches']}; "
        f"{launches}; chain_dot yt-sim {serve['launches']}, fl-sim ingest "
        f"{refresh['serve_launches']}")

    by_path = lambda name: {path: n[name] for path, n in launches.items() if n[name]}
    flash = flash_shapes[LM_ARCH]      # the top-level numbers: qwen3-1.7b's prefill shape
    print(json.dumps({"kernels": [{
        "name": "sgns_lifetime",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sgns/csrc/sgns_lifetime.cu",
        "replaces": "src/repro/kernels/sgns/kernel.py:121",
        "launches": total["sgns_lifetime"],
        "max_abs_err": sgns_err,
        "ms": sgns["ms"],
        "plain_ms": sgns["plain_ms"],
        "bound_ms": sgns["bound_ms"],
        "bound_by": sgns["bound_by"],
        "library_ms": None,
        "launches_by_path": {"yt-sim k=2": emb[2]["launches"], "yt-sim k=1": emb[1]["launches"],
                             "yt-sim k=2 durable": durable["launches"], **refresh["launches"]},
        "ms_s1": sgns["ms_s1"],
        "padded_bound_ms": sgns["padded_bound_ms"],
        "step_ms": sgns["step_ms"],
        "us_per_position": sgns["us_per_position"],
        "extent": sgns["extent"],
        "graph_replays": emb[2]["replays"] + emb[1]["replays"] + durable["replays"]
        + refresh["replays"],
        "writeback_launches": emb[2]["writebacks"] + emb[1]["writebacks"]
        + durable["writebacks"] + refresh["writebacks"],
        "checked_chunk_extra_ms": durable["checked_extra_ms"],
        "writeback_ms": sgns["writeback_ms"],
        "writeback_plain_ms": sgns["writeback_plain_ms"],
        "writeback_bound_ms": sgns["writeback_bound_ms"],
        "writeback_max_abs_err": sgns["writeback_max_abs_err"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": total["flash_attention"],
        "launches_by_path": by_path("flash_attention"),
        "max_abs_err": flash_err,
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "by_shape": flash_shapes,
        "train": {"step_ms": train["steps"]["step_ms"],
                  "tokens_per_s": train["steps"]["tokens_per_s"],
                  "peak_gib": train["steps"]["peak_gib"],
                  "shape": [TRAIN_BATCH, lm_cfg.num_heads, lm_cfg.num_kv_heads, TRAIN_SEQ,
                            lm_cfg.resolved_head_dim],
                  "backward": "plain (ref.mha_reference under autograd)"},
        "encdec": {"prefill_s": encdec["serve"]["prefill_s"],
                   "warm_prefill_s": encdec["serve"]["warm_prefill_s"],
                   "decode_ms": encdec["serve"]["decode_ms"],
                   "waves": [list(w) for w in ENCDEC_WAVES],
                   "serve_peak_gib": encdec["serve"]["peak_gib"],
                   "decode_vs_fresh_prefill": encdec["serve"]["worst"],
                   "train_step_ms": encdec["train"]["step_ms"],
                   "train_peak_gib": encdec["train"]["peak_gib"]},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:79",
        "launches": total["ssd_scan"],
        "launches_by_path": by_path("ssd_scan"),
        "max_abs_err": max(ssd_err, train["grad_err"]["ssd_scan"]),
        "ms": ssd["ms"],
        "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        "library_ms": None,
        "grouped_bound_ms": ssd["bound_ms"],
        "broadcast_bound_ms": ssd["broadcast_bound_ms"],
        "ms_3d": ssd["ms_3d"],
        "shape": ssd["shape"],
    }, {
        "name": "ssd_scan_wide",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssd_wide.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:79",
        "reference_on_path": "src/repro/models/xlstm.py:112 ssd_chunked_ref (plain jnp; the "
                             "wide route computes the function of _ssd_kernel, "
                             "src/repro/kernels/ssm_scan/kernel.py:27)",
        "launches": total["ssd_scan_wide"],
        "launches_by_path": by_path("ssd_scan_wide"),
        "max_abs_err": max(wide_err, train["grad_err"]["ssd_scan_wide"]),
        "ms": wide_t["ms"],
        "plain_ms": wide_t["plain_ms"],
        "bound_ms": wide_t["bound_ms"],
        "bound_by": wide_t["bound_by"],
        "library_ms": None,
        "ms_by_kernel": wide_t["ms_by_kernel"],
        "shape": wide_t["shape"],
    }, {
        "name": "chain_dot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/chain_dot/csrc/chain_dot.cu",
        "replaces": "src/repro/runtime/serve.py:108-149 (XLA, no pallas_call)",
        "launches": total["chain_dot"],
        "launches_by_path": {"yt-sim serve": serve["launches"],
                             "fl-sim ingest serve": refresh["serve_launches"]},
        "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "sort_ms": serve["sort_ms"],
        "ms_b1": serve["ms_b1"],
        "bound_ms_b1": serve["bound_ms_b1"],
        "pair_ms": serve["pair_ms"],
        "pair_plain_ms": serve["pair_plain_ms"],
        "bit_exact_cases": serve["cases"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
