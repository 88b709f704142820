#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their plain versions.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each failure raises and ends the run with a non-zero exit):

1. Build both kernels with nvcc for sm_90a, one nvcc each, started
   together: the SGNS lifetime kernel (``kernels/sgns/csrc``) and the flash
   attention kernel (``kernels/flash_attention/csrc``). Print the
   compiler's register/shared-memory report and the card's name and
   power limit.
2. Hold each kernel against its plain torch version on the card: SGNS at
   the paper width and two ragged shapes (5e-4); flash attention at the
   reference's test shapes and at the LM path's prefill shape (2e-3 in
   float32, 2e-2 in bfloat16).
3. The embedding path: ``embed_graph`` with ``PAPER_EMBED`` on the
   ``yt-sim`` R-MAT preset (1,138,499 nodes), one replica. The SGNS
   kernel must have launched; phi must be finite and the link-prediction
   AUC above 0.75. Then time SGNS on a lifetime batch gathered from this
   run's corpus and embeddings.
4. The LM path: ``Server`` serving qwen3-1.7b at full width (28 layers,
   d 2048, bf16, seeded random weights) to 8 requests with prompts of
   512-2,048 tokens and 32 new tokens each, in waves of 4 slots over a
   4,096-position cache. Flash attention must have launched 28 times per
   prefill. A fresh prefill over each wave's prompts plus its first n
   generated tokens (n = 1, 16, 31) must give decode step n's logits.
   Then time flash attention at the prefill shape, against its plain
   version and ``scaled_dot_product_attention``.

Each path runs with every launch count set to 0 just before it and read
just after. Prints one JSON line with the kernels' numbers and, last, the
device line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SGNS_TOL = 5e-4
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
PAPER_SHAPE = dict(G=64, W=2, T=100, D=128, K=5, window=10)
RAGGED_SHAPES = [dict(G=5, W=2, T=37, D=96, K=5, window=10),
                 dict(G=7, W=3, T=23, D=128, K=4, window=5)]
# The reference's flash-attention test cases (tests/test_kernels.py):
# (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype).
FLASH_CASES = [(1, 1, 1, 128, 128, 64, c, 0, "float32") for c in (True, False)] + \
              [(2, 2, 2, 256, 256, 32, c, 0, "float32") for c in (True, False)] + \
              [(1, 4, 4, 512, 512, 64, c, 0, "float32") for c in (True, False)] + \
              [(2, 1, 1, 384, 384, 128, True, 0, "float32"),
               (1, 2, 2, 256, 256, 64, True, 0, "float32"),
               (1, 2, 2, 256, 256, 64, True, 0, "bfloat16"),
               (1, 2, 2, 128, 256, 64, True, 128, "float32")]
LM_ARCH = "qwen3-1.7b"
LM_REQUESTS, LM_NEW_TOKENS, LM_SLOTS, LM_MAX_LEN = 8, 32, 4, 4096
LM_PROMPT_LENS = (512, 2048)
KV_CHECK_STEPS = (1, 16, 31)
KV_CHECK_TOL = 2e-2            # of the largest |logit|
KV_STATE_TOL = 5e-2            # of the largest |k| or |v| entry, per layer
H100_F32_FLOPS = 67e12          # FP32 outside the tensor cores, SXM, 700 W
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, SXM, 700 W
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
    early (-1 padding) when ``invalid``."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: (torch.randn(*s, generator=gen) * 0.1).to(device)
    ctx, out, neg = rnd(G, W, T, D), rnd(G, W, T, D), rnd(G, T, K, D)
    if invalid:
        lengths = torch.randint(0, T + 1, (G, W), generator=gen)
        valid = torch.arange(T)[None, None, :] < lengths[:, :, None]
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


def sgns_bound_ms(torch, ctx, out, neg, valid, window) -> tuple:
    """Least time for the update on an H100: bytes (each input read once,
    each output written once) over the memory rate, against the f32 FMAs
    the valid (row, column) pairs need (logits, C update, T update) over
    the f32 peak. Returns (ms, "bytes" | "operations")."""
    G, W, T, D = ctx.shape
    K = neg.shape[2]
    nbytes = (2 * (ctx.numel() + out.numel() + neg.numel()) * 4
              + valid.numel() * valid.element_size() + G * 4)
    v = valid.to(torch.int64)
    pad = torch.nn.functional.pad(v, (window, window))
    # valid context positions p-w..p+w (minus p) of walk w, where walk w's target is valid
    win = sum(pad[:, :, window + o: window + o + T] for o in range(-window, window + 1) if o)
    rows = (win * v).sum(dim=1)                      # (G, T) valid rows per position
    cols = v.sum(dim=1) + K                          # (G, T) valid columns
    flops = 2 * 3 * D * int((rows * cols).sum())
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- flash attention (K2) ---------------------------------------------------

def flash_inputs(torch, b, hq, hkv, sq, skv, d, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(*s, generator=gen).to(device, dt)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def flash_check(torch, fa_ops, fa_ref, case, seed, device) -> float:
    """Kernel against ``mha_reference`` on the card; raises outside the tolerance."""
    b, hq, hkv, sq, skv, d, causal, q_offset, dtype = case
    q, k, v = flash_inputs(torch, b, hq, hkv, sq, skv, d, dtype, seed, device)
    got = fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = fa_ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = FLASH_TOL[dtype]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention {case}: differs by {err:.3e}")
    return err


def flash_bound_ms(b, hq, hkv, s, d, elem_bytes) -> tuple:
    """Least time for causal attention at q_offset 0 on an H100: the
    products of the visible (query, key) pairs (q.k and p.v, 2 flops each
    per dimension) over the dense bf16 tensor-core peak, against q, k, v
    read once and o written once over the memory rate."""
    visible = s * (s + 1) // 2
    flops = 4 * b * hq * d * visible
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * elem_bytes
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- the LM path ------------------------------------------------------------

def lm_prompts(np, vocab: int):
    """The LM path's traffic: 8 prompts, lengths uniform on 512..2,048,
    tokens uniform over the vocabulary, from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def tap(torch, server, seconds):
    """Record each prefill's and decode step's logits, each wave's caches
    (a prefill makes them, decode updates them in place), and the wall time
    of each kind of call (the device drained before and after)."""
    calls, wave_caches = [], []
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
        return logits, caches

    server._prefill = lambda *a: timed("prefill", prefill, *a)
    server._decode = lambda *a: timed("decode", decode, *a)
    return calls, wave_caches


def cache_diff(served, fresh, rows: int) -> float:
    """Largest |served - fresh| over cache positions [0, rows) of every
    layer's k and v, over that tensor's largest |fresh| entry."""
    worst = 0.0
    for group, reps in fresh.items():
        for rep_served, rep_fresh in zip(served[group], reps):
            for block, kv in rep_fresh.items():
                for name, want in kv.items():
                    want = want[:, :, :rows].float()
                    got = rep_served[block][name][:, :, :rows].float()
                    worst = max(worst, (got - want).abs().max().item() / want.abs().max().item())
    return worst


def kv_cache_check(torch, np, server, prefill, waves, calls, wave_caches) -> tuple:
    """For each wave and n in KV_CHECK_STEPS, a fresh prefill over the
    wave's left-padded prompts plus its first n generated tokens must give
    decode step n's last-token logits (within KV_CHECK_TOL x max |logit|)
    and the served cache's first plen + n positions (within KV_STATE_TOL x
    max |entry|, in every layer's k and v). Returns the worst of each."""
    worst, worst_state = 0.0, 0.0
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
            state = cache_diff(wave_caches[w], fresh_caches, plen + n)
            log(f"[lm] wave {w} step {n}: fresh prefill vs decode max |diff| {diff:.4f} "
                f"(max |logit| {scale:.2f}); cache positions 0..{plen + n - 1} differ by "
                f"{state:.5f} of the largest entry")
            if not diff <= KV_CHECK_TOL * scale:
                raise AssertionError(f"wave {w} step {n}: KV-cache logits differ by {diff} "
                                     f"> {KV_CHECK_TOL} x {scale}")
            if not state <= KV_STATE_TOL:
                raise AssertionError(f"wave {w} step {n}: the served cache differs from a "
                                     f"fresh prefill's by {state} > {KV_STATE_TOL}")
            top2 = step.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > diff
            if not torch.equal(fresh.argmax(-1)[sure], step.argmax(-1)[sure]):
                raise AssertionError(f"wave {w} step {n}: argmax differs where the "
                                     f"top-2 margin exceeds {diff}")
            worst = max(worst, diff / scale)
            worst_state = max(worst_state, state)
            del fresh_caches
    return worst, worst_state


def kv_cache_mutation(torch, np, server, prefill, decode, wave) -> None:
    """The power of ``kv_cache_check``: decode step 1 of ``wave`` with a
    cache fault must fail it. The faults: the cache length off by -1 or +1
    (the new token's key and value land in the wrong slot, and its rope
    phase shifts with it), and the rope phase alone off by +1 (decoded at
    +1, then its entries moved back to the right slot). Each fault's cache
    must differ from a fresh prefill's by more than KV_STATE_TOL; the
    logits' difference is printed beside it."""
    plen = max(len(r.prompt) for r in wave)
    toks = np.zeros((len(wave), plen + 1), np.int64)
    for i, r in enumerate(wave):
        toks[i, plen - len(r.prompt):plen] = r.prompt
        toks[i, plen] = r.output[0]
    toks = torch.as_tensor(toks, device=server.device)
    fresh, fresh_caches = prefill(server.params, {"tokens": toks})
    fresh = fresh.float()
    scale = fresh.abs().max().item()
    for fault, shift, move_back in (("cache length -1", -1, False),
                                    ("cache length +1", 1, False),
                                    ("rope phase +1", 1, True)):
        _, caches = prefill(server.params, {"tokens": toks[:, :plen]})
        step, caches = decode(server.params, caches, toks[:, plen:], plen + shift)
        if move_back:
            for reps in caches.values():
                for rep in reps:
                    for kv in rep.values():
                        for t in kv.values():
                            t[:, :, plen] = t[:, :, plen + 1]
                            t[:, :, plen + 1] = 0
        state = cache_diff(caches, fresh_caches, plen + 1)
        logit = (step.float() - fresh).abs().max().item() / scale
        log(f"[lm] mutation {fault}: cache differs by {state:.5f} of the largest entry "
            f"(bound {KV_STATE_TOL}); logits by {logit:.5f} of the largest (bound {KV_CHECK_TOL})")
        if not state > KV_STATE_TOL:
            raise AssertionError(f"the KV-cache check misses a fault ({fault}): "
                                 f"{state} <= {KV_STATE_TOL}")
        del caches


def lm_path(torch, np, fa_ops, counters, cfg, prompts, device="cuda") -> int:
    """Serve ``cfg`` (qwen3-1.7b at full width) to ``prompts`` and check the
    KV cache; returns the flash kernel's launches while serving."""
    from repro_torch.models import zoo
    from repro_torch.runtime.server import Request, Server, ServerConfig, throughput_stats

    t0 = time.perf_counter()
    params = zoo.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {cfg.param_count()} parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s")
    server = Server(cfg, params, ServerConfig(batch_slots=LM_SLOTS, max_len=LM_MAX_LEN),
                    device=device)
    prefill, decode = server._prefill, server._decode
    seconds = {"prefill": 0.0, "decode": 0.0}
    calls, wave_caches = tap(torch, server, seconds)
    requests = [Request(i, p, LM_NEW_TOKENS) for i, p in enumerate(prompts)]
    log(f"[lm] {len(requests)} requests, prompt lengths {[len(p) for p in prompts]}, "
        f"{LM_NEW_TOKENS} new tokens each, {LM_SLOTS} slots, cache {LM_MAX_LEN}")

    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30

    waves = [done[i:i + LM_SLOTS] for i in range(0, len(done), LM_SLOTS)]
    prefills = len(waves)
    n_out = sum(len(r.output) for r in done)
    n_prompt = sum(len(p) for p in prompts)
    stats = throughput_stats(n_out, wall)
    log(f"[lm] serve wall {wall:.3f} s: prefill {seconds['prefill']:.3f} s "
        f"({prefills} calls, {n_prompt} prompt tokens, "
        f"{n_prompt / seconds['prefill']:.1f} prompt tok/s), decode {seconds['decode']:.3f} s "
        f"({len(calls) - prefills} steps, {seconds['decode'] / (len(calls) - prefills) * 1e3:.3f} "
        f"ms/step); {stats['tokens']} generated tokens, {stats['tok_per_s']:.2f} tok/s")
    log(f"[lm] peak device memory {peak:.3f} GiB; flash_attention launches {launches}")
    if launches != cfg.num_layers * prefills:
        raise AssertionError(f"flash_attention launched {launches} times, not "
                             f"{cfg.num_layers} x {prefills} prefills")
    for r in done:
        if r.output is None or r.output.shape != (LM_NEW_TOKENS,) or \
                not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    if not all(torch.isfinite(c.float()).all() for c in calls):
        raise AssertionError("non-finite logits")
    log(f"[lm] first request's tokens {done[0].output.tolist()}")
    worst, worst_state = kv_cache_check(torch, np, server, prefill, waves, calls, wave_caches)
    log(f"[lm] KV-cache consistency: worst |diff| / max |logit| {worst:.5f} "
        f"(bound {KV_CHECK_TOL}); worst cache |diff| / max |entry| {worst_state:.5f} "
        f"(bound {KV_STATE_TOL})")
    del wave_caches, calls
    kv_cache_mutation(torch, np, server, prefill, decode, waves[0])
    return launches


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

    from repro_torch.configs import get_config
    from repro_torch.configs.distger import GRAPH_PRESETS, PAPER_EMBED
    from repro_torch.core import dsgl
    from repro_torch.core.api import embed_graph
    from repro_torch.eval import link_prediction_auc
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.sgns import ops, ref

    counters = {"sgns_lifetime": ops, "flash_attention": fa_ops}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build_all([ops.LIBRARY, fa_ops.LIBRARY])
    log(f"[build] {ops.LIBRARY.library_path().name}, {fa_ops.LIBRARY.library_path().name} "
        f"in {time.perf_counter() - t0:.2f} s")
    for lib in (ops.LIBRARY, fa_ops.LIBRARY):
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {lib.name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)

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

    lm_cfg = get_config(LM_ARCH)
    prompts = lm_prompts(np, lm_cfg.vocab_size)
    s_prefill = max(len(p) for p in prompts)     # the longest padded prompt
    prefill_case = (LM_SLOTS, lm_cfg.num_heads, lm_cfg.num_kv_heads, s_prefill, s_prefill,
                    lm_cfg.resolved_head_dim, True, 0, "bfloat16")
    flash_err = 0.0
    for i, case in enumerate([*FLASH_CASES, prefill_case]):
        err = flash_check(torch, fa_ops, fa_ref, case, seed=100 + i, device=dev)
        flash_err = max(flash_err, err)
        log(f"[check] flash_attention {case}: max abs err {err:.3e}")

    # 3. the embedding path ------------------------------------------------------
    preset = GRAPH_PRESETS["yt-sim"]
    t0 = time.perf_counter()
    graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[main] {preset.name}: |V|={graph.num_nodes} arcs={graph.num_edges} "
        f"graph built in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].LAUNCHES = 0
    t0 = time.perf_counter()
    phi_in, phi_out, corpus, stats = embed_graph(
        graph, PAPER_EMBED, num_shards=1, return_corpus=True,
        return_stats=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sgns_launches = ops.LAUNCHES
    ws = stats["stats"]
    log(f"[main] embed_graph wall {wall:.2f} s (Cm {stats['cm_s']:.2f} s, "
        f"pipeline {stats['wall_s']:.2f} s: walks {ws['phase_s']['walk']:.2f} s, "
        f"training {ws['phase_s']['train']:.2f} s)")
    log(f"[main] walks/round {graph.num_nodes} rounds {stats['rounds']} "
        f"training steps {stats['steps']} K1 launches {sgns_launches} "
        f"K2 launches {fa_ops.LAUNCHES}")
    log(f"[main] mean walk length {ws['mean_len']:.4f} supersteps {ws['supersteps']} "
        f"per batch {ws['batch_supersteps']} accepts {ws['accepts']} rejects {ws['rejects']}")
    log(f"[main] D history {ws['d_history']}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if sgns_launches <= 0:
        raise AssertionError("the embedding path did not launch the sgns_lifetime kernel")
    if not (torch.isfinite(phi_in).all() and torch.isfinite(phi_out).all()):
        raise AssertionError("phi is not finite")
    t0 = time.perf_counter()
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    log(f"[main] link-prediction AUC {auc:.6f} ({time.perf_counter() - t0:.2f} s)")
    if not auc > 0.75:
        raise AssertionError(f"AUC {auc} <= 0.75")

    G, W, T, D, K, w = (PAPER_SHAPE[k] for k in ("G", "W", "T", "D", "K", "window"))
    rng = np.random.default_rng(1)
    walks = torch.as_tensor(
        corpus.walks[rng.choice(corpus.num_walks, G * W, replace=False)],
        device=dev).reshape(G, W, T)
    safe = walks.clamp_min(0).to(torch.int64)
    table = dsgl.build_alias_table(corpus.ocn, 0.75, dev)
    negs = dsgl.sample_alias(table, (0, 1), (G, T, K))
    ctx, out, neg = phi_in[safe], phi_out[safe], phi_out[negs]
    valid = walks >= 0
    got = ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, w)
    want = ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, w)
    sgns_err = max(sgns_err, sgns_compare(torch, got, want, "sgns_lifetime main-path batch"))
    sgns_ms = time_ms(torch, lambda: ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, w), 50)
    sgns_plain = time_ms(torch, lambda: ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, w), 5)
    sgns_bound, sgns_by = sgns_bound_ms(torch, ctx, out, neg, valid, w)
    log(f"[time] sgns_lifetime on main-path batch (valid {valid.float().mean().item():.4f}): "
        f"kernel {sgns_ms:.4f} ms, plain {sgns_plain:.4f} ms, bound {sgns_bound:.6f} ms ({sgns_by})")
    del phi_in, phi_out, corpus, graph, ctx, out, neg, got, want
    torch.cuda.empty_cache()

    # 4. the LM path -------------------------------------------------------------
    flash_launches = lm_path(torch, np, fa_ops, counters, lm_cfg, prompts)
    b, hq, hkv, s, _, d, _, _, dtype = prefill_case
    q, k, v = flash_inputs(torch, b, hq, hkv, s, s, d, dtype, seed=7, device=dev)
    flash_ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v), 20)
    flash_plain = time_ms(torch, lambda: fa_ref.mha_reference(q, k, v), 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
    flash_bound, flash_by = flash_bound_ms(b, hq, hkv, s, d, q.element_size())
    log(f"[time] flash_attention at the prefill shape q {tuple(q.shape)} kv {tuple(k.shape)} "
        f"{dtype}: kernel {flash_ms:.4f} ms, plain {flash_plain:.4f} ms, sdpa {sdpa_ms:.4f} ms, "
        f"bound {flash_bound:.6f} ms ({flash_by})")

    print(json.dumps({"kernels": [{
        "name": "sgns_lifetime",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sgns/csrc/sgns_lifetime.cu",
        "replaces": "src/repro/kernels/sgns/kernel.py:121",
        "launches": sgns_launches,
        "max_abs_err": sgns_err,
        "ms": sgns_ms,
        "plain_ms": sgns_plain,
        "bound_ms": sgns_bound,
        "bound_by": sgns_by,
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "ms": flash_ms,
        "plain_ms": flash_plain,
        "bound_ms": flash_bound,
        "bound_by": flash_by,
        "library_ms": sdpa_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
