"""Where the PyTorch port's time goes on the card, phase by phase.

Runs the embedding path's two phases on one GPU — the first 40 walk
supersteps of round 0 and 100 DSGL training steps over round 0's walks,
as ``embed_graph(PAPER_EMBED, num_shards=2)`` runs them on the yt-sim
R-MAT preset (two replicas, a hotness sync at the step-50 boundary), the
walk window on the dense engine and then on the partition-sharded one
(replicated at k = 2 under MPGP, the main path's; partition-local at k = 2
under MPGP and at k = 4 under the hash partition) —
and the LM serving paths' two each — one prefill of 4 prompts of 2,048
tokens and 10 decode steps after it, qwen3-1.7b, zamba2-7b, xlstm-350m,
minicpm3-4b and then deepseek-v2-lite-16b (MLA + MoE at its published
capacity factor) at full width over a 4,096-position cache, as
``chip_smoke.py``'s server runs them — and one LM training step of
qwen3-1.7b at full width, each first timed plainly and then under
``torch.profiler``.
The training window runs the pipeline's path on the card: two chunks of
50 steps, each one CUDA graph replay, after a warm-up call that captures
the graph; each prefill window comes after an untimed prefill, which
builds the LM kernels on first use. For each phase it prints the wall time per step, the device
time per step between CUDA events around the plain run, the device-busy
time per step (the sum of the kernels' times in the trace, which records
the kernels a graph replays), their ratio, the kernel launches per step,
the kernels that take the most device time and the share of the port's
own kernels (K1 ``sgns_lifetime`` and its write-back: its keys, the
library's radix sort and the short and long row segments; K2 ``flash``,
with MLA's ``flash_kernel_sm90_wide`` at D = 288 and
``flash_kernel_sm90_split3`` at D = 576 also shown apart; K3
``ssd_chunk_state`` and ``ssd_chunk_out``, and its wide route's
``wide_cum``, ``wide_cb_state``, ``wide_chain`` and ``wide_out``) in the
device time.

    PYTHONPATH=src python3 -m repro_torch.profile [embed | train | ARCH ...]

With ``embed`` it profiles the embedding path only; with architecture
names (of ``LM_ARCHS``) only those models' LM windows; with ``train`` only
the LM training window: one step of qwen3-1.7b at full width and depth
(batch 4 x seq 2,048), with the device time inside K2's backward (the
plain version's, ``flash_attention.plain_backward``) printed apart.

It needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

PRESET = "yt-sim"
SUPERSTEPS = 40
STEPS = 100
LM_ARCHS = ("qwen3-1.7b", "zamba2-7b", "xlstm-350m", "minicpm3-4b", "deepseek-v2-lite-16b")
LM_SLOTS, LM_PROMPT, LM_MAX_LEN, LM_DECODE_STEPS = 4, 2048, 4096, 10
# Substrings of the port's kernel names: "flash_kernel" matches all of
# K2's, flash_kernel (float32), flash_kernel_sm90 (bfloat16) and
# flash_kernel_sm90_wide and flash_kernel_sm90_split3 (bfloat16 at MLA's D =
# 288 and 576, also shown apart); K3 is two
# launches, its states (with C B^T) and its output, and its wide route four:
# cum, C B^T with the chunks' local states, their chain, and the output.
OWN_KERNELS = ("sgns_lifetime_kernel", "sgns_wb_keys_kernel", "RadixSort",
               "sgns_wb_segments_kernel", "sgns_wb_long_kernel", "flash_kernel",
               "flash_kernel_sm90_wide", "flash_kernel_sm90_split3",
               "ssd_chunk_state_kernel", "ssd_chunk_out_kernel", "wide_cum_kernel",
               "wide_cb_state_kernel", "wide_chain_kernel", "wide_out_kernel")
SHARDS = 2
# Named host ranges whose device time is printed apart (not counted as kernels):
# K2's backward, the plain version's under autograd.
RANGES = ("flash_attention.plain_backward",)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "qwen3-1.7b", 4, 2048
SHARDED_WINDOWS = (("replicated", 2, "mpgp"), ("local", 2, "mpgp"), ("local", 4, "hash"))


def _device_total_us(evt) -> float:
    """Device time of the kernels launched inside a host range."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_window(torch, label: str, fn, count: int, warmup: bool = False) -> None:
    """Time ``fn`` (``count`` steps) plainly, then once more under the
    profiler; print the per-step numbers and the top kernels. ``warmup``
    runs ``fn`` once first, untimed."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{label}] device time between CUDA events {start.elapsed_time(end) / count:.4f} "
          f"ms/step", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0 and str(e.device_type).endswith("CUDA")
               and e.key not in RANGES]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[{label}] wall {wall / count * 1e3:.4f} ms/step over {count} steps; "
          f"device busy {busy_us / count / 1e3:.4f} ms/step "
          f"({busy_us / 1e6 / wall * 100:.2f}% of the plain wall time); "
          f"{launches / count:.1f} device ops/step", flush=True)
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        print(f"[{label}]   {_device_us(e) / count / 1e3:9.4f} ms/step  x{e.count / count:6.1f}  "
              f"{e.key[:90]}", flush=True)
    for name in OWN_KERNELS:
        own = [e for e in kernels if name in e.key]
        if own:
            us = sum(_device_us(e) for e in own)
            print(f"[{label}]   {name}: {us / count / 1e3:.4f} ms/step over "
                  f"{sum(e.count for e in own) / count:.1f} launches/step, "
                  f"{us / busy_us * 100:.2f}% of the device-busy time", flush=True)
    for name in RANGES:
        spans = [e for e in events if e.key == name]
        if spans:
            us = max(max(_device_us(e), _device_total_us(e)) for e in spans)
            print(f"[{label}]   {name}: {us / count / 1e3:.4f} ms/step of device time "
                  f"in {max(e.count for e in spans) / count:.1f} ranges/step, "
                  f"{us / busy_us * 100:.2f}% of the device-busy time", flush=True)


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("repro_torch.profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import prng
    from repro_torch.configs.distger import GRAPH_PRESETS, PAPER_EMBED
    from repro_torch.core.api import make_walk_plan
    from repro_torch.core.dsgl import DSGLConfig, build_alias_table
    from repro_torch.core.walker import LaneKeys, _superstep, init_batch
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if "train" in argv:
        train_window(torch, torch.device("cuda"))
        return 0
    archs = [a for a in argv if a in LM_ARCHS]
    if archs:
        for arch in archs:
            lm_windows(torch, torch.device("cuda"), arch)
            torch.cuda.empty_cache()
        return 0
    preset = GRAPH_PRESETS[PRESET]
    dev = torch.device("cuda")
    graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0, device=dev)
    cfg = PAPER_EMBED
    policy, spec, rounds = make_walk_plan(cfg)
    pipe = StreamingEmbedPipeline(
        graph, policy, spec, rounds,
        DSGLConfig(dim=cfg.dim, window=cfg.window, negatives=cfg.negatives,
                   epochs=cfg.epochs, lr=cfg.lr, multi_windows=cfg.multi_windows,
                   seed=cfg.seed), num_shards=SHARDS)
    print(f"[setup] {preset.name}: |V|={graph.num_nodes} Cm {pipe.cm_seconds:.3f} s", flush=True)

    # Walks: the first supersteps of round 0, all lanes busy.
    def walk_window():
        keys = LaneKeys.for_round(prng.fold_in(pipe.key_walk, 0), 0,
                                  len(pipe.sources), dev)
        st = init_batch(pipe.sources, keys, spec)
        for _ in range(SUPERSTEPS):
            st = _superstep(pipe.graph, policy, spec, st)
            bool(st.active.any())                     # the loop's per-superstep sync

    profile_window(torch, "walk", walk_window, SUPERSTEPS)

    # The same supersteps on the sharded engine, each run cut at them.
    import dataclasses

    from repro_torch.core import mpgp
    from repro_torch.core.shard_engine import run_walk_sharded

    window_spec = dataclasses.replace(spec, max_supersteps=SUPERSTEPS)
    for engine, k, name in SHARDED_WINDOWS:
        part = (mpgp.mpgp_partition if name == "mpgp" else mpgp.hash_partition)(
            pipe.graph, k).assignment

        def sharded_window(engine=engine, k=k, part=part):
            keys = LaneKeys.for_round(prng.fold_in(pipe.key_walk, 0), 0,
                                      len(pipe.sources), dev)
            run_walk_sharded(pipe.graph, pipe.sources, keys, policy, window_spec, part, k,
                             engine=engine)

        profile_window(torch, f"walk {engine} k={k} {name}", sharded_window, SUPERSTEPS,
                       warmup=True)

    # Training: steps over round 0's ring slots, as the pipeline runs them.
    pipe._append(pipe._run_round(0), 0)
    ocn = pipe.ring.ocn.cpu().numpy()
    table = build_alias_table(ocn, pipe.cfg.neg_power, dev)
    n = graph.num_nodes
    profile_window(torch, "train",
                   lambda: pipe._train_slots(0, n, ocn, STEPS, table=table),
                   STEPS, warmup=True)
    print(f"[train] {pipe.syncs} hotness syncs in the windows", flush=True)
    del pipe, graph, table
    torch.cuda.empty_cache()
    if "embed" in argv:
        return 0
    for arch in LM_ARCHS:
        lm_windows(torch, dev, arch)
        torch.cuda.empty_cache()
    train_window(torch, dev)
    return 0


def train_window(torch, dev) -> None:
    """One LM training step of qwen3-1.7b at full width and depth (batch 4 x
    seq 2,048, AdamW with float32 moments, remat per block), as
    ``chip_smoke.py``'s [train] phase runs it, after an untimed step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import zoo
    from repro_torch.optim.optimizers import AdamWConfig, init_opt_state
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime.trainer import make_train_step

    cfg = get_config(TRAIN_ARCH)
    params = zoo.init_params(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    step_fn = make_train_step(cfg, opt_cfg, constant(3e-4))
    batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in TokenStream(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0).items()}

    def step_window():
        state["params"], state["opt"], _ = step_fn(state["params"], state["opt"], batch, 0)

    profile_window(torch, f"{TRAIN_ARCH} train", step_window, 1, warmup=True)


def lm_windows(torch, dev, arch: str) -> None:
    """One prefill and the decode steps after it, as the server runs them."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config(arch)
    params = zoo.init_params(cfg, seed=0, device=dev)
    prefill, decode = zoo.prefill_fn(cfg, LM_MAX_LEN), zoo.decode_fn(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (LM_SLOTS, LM_PROMPT), generator=gen, device=dev)
    state = {}

    def prefill_window():
        state["logits"], state["caches"] = prefill(params, {"tokens": tokens})

    def decode_window():
        logits, caches = state["logits"], state["caches"]
        for t in range(LM_DECODE_STEPS):
            cur = torch.argmax(logits, dim=-1)[:, None]
            logits, caches = decode(params, caches, cur, LM_PROMPT + t)

    # One untimed prefill first: it builds the kernels on first use, which
    # would otherwise land in the plain window's wall time.
    profile_window(torch, f"{arch} prefill", prefill_window, 1, warmup=True)
    profile_window(torch, f"{arch} decode", decode_window, LM_DECODE_STEPS)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
