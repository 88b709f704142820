#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernel to its plain version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each failure raises and ends the run with a non-zero exit):

1. Build the SGNS lifetime kernel (``src/repro_torch/kernels/sgns/csrc``)
   with nvcc for sm_90a, print the compiler's register/shared-memory
   report and the card's name and power limit.
2. Hold the kernel against its plain torch version on the card, at the
   paper width (G=64, W=2, T=100, d=128, K=5, w=10) and at two ragged
   shapes with invalid tokens: atol/rtol 5e-4 on the updated buffers, the
   loss within 5e-4 of its magnitude.
3. The main path: ``embed_graph`` with ``PAPER_EMBED`` on the ``yt-sim``
   R-MAT preset (1,138,499 nodes), one replica, on the card. Counts the
   kernel's launches (must be > 0), checks that phi is finite and that the
   link-prediction AUC exceeds 0.75.
4. Time the kernel, its plain version and the bound on a lifetime batch
   gathered from the main path's own corpus and embeddings.

Prints one JSON line with the kernel's numbers and, last, the device line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 5e-4
PAPER_SHAPE = dict(G=64, W=2, T=100, D=128, K=5, window=10)
RAGGED_SHAPES = [dict(G=5, W=2, T=37, D=96, K=5, window=10),
                 dict(G=7, W=3, T=23, D=128, K=4, window=5)]
H100_F32_FLOPS = 67e12          # FP32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def random_inputs(torch, G, W, T, D, K, window, seed, device, invalid=True):
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


def compare(torch, got, want, what: str) -> float:
    """Max abs error over the buffers; raises outside the tolerance."""
    err = 0.0
    for name, a, b in zip(("ctx", "out", "neg"), got[:3], want[:3]):
        if not torch.allclose(a, b, atol=TOL, rtol=TOL):
            raise AssertionError(f"{what}: {name} differs by "
                                 f"{(a - b).abs().max().item():.3e}")
        err = max(err, (a - b).abs().max().item())
    lk, lr_ = got[3], want[3]
    if not torch.all((lk - lr_).abs() <= TOL * lr_.abs().clamp_min(1.0)):
        raise AssertionError(f"{what}: loss differs by {(lk - lr_).abs().max().item():.3e}")
    return err


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


def bound_ms(torch, ctx, out, neg, valid, window) -> tuple:
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

    from repro_torch.configs.distger import GRAPH_PRESETS, PAPER_EMBED
    from repro_torch.core import dsgl
    from repro_torch.core.api import embed_graph
    from repro_torch.eval import link_prediction_auc
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.sgns import build, ops, ref

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"[build] {build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)

    # 2. kernel against its plain version -------------------------------------
    max_err = 0.0
    for i, shape in enumerate([PAPER_SHAPE, *RAGGED_SHAPES]):
        ctx, out, neg, valid = random_inputs(torch, **shape, seed=i, device=dev,
                                             invalid=i > 0)
        got = ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, shape["window"])
        want = ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, shape["window"])
        torch.cuda.synchronize()
        err = compare(torch, got, want, f"sgns_lifetime {shape}")
        max_err = max(max_err, err)
        log(f"[check] sgns_lifetime {shape}: max abs err {err:.3e}")

    # 3. main path ------------------------------------------------------------
    preset = GRAPH_PRESETS["yt-sim"]
    t0 = time.perf_counter()
    graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[main] {preset.name}: |V|={graph.num_nodes} arcs={graph.num_edges} "
        f"graph built in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    phi_in, phi_out, corpus, stats = embed_graph(
        graph, PAPER_EMBED, num_shards=1, return_corpus=True,
        return_stats=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    ws = stats["stats"]
    log(f"[main] embed_graph wall {wall:.2f} s (Cm {stats['cm_s']:.2f} s, "
        f"pipeline {stats['wall_s']:.2f} s: walks {ws['phase_s']['walk']:.2f} s, "
        f"training {ws['phase_s']['train']:.2f} s)")
    log(f"[main] walks/round {graph.num_nodes} rounds {stats['rounds']} "
        f"training steps {stats['steps']} K1 launches {launches}")
    log(f"[main] mean walk length {ws['mean_len']:.4f} supersteps {ws['supersteps']} "
        f"per batch {ws['batch_supersteps']} accepts {ws['accepts']} rejects {ws['rejects']}")
    log(f"[main] D history {ws['d_history']}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches <= 0:
        raise AssertionError("the main path did not launch the sgns_lifetime kernel")
    if not (torch.isfinite(phi_in).all() and torch.isfinite(phi_out).all()):
        raise AssertionError("phi is not finite")
    t0 = time.perf_counter()
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    log(f"[main] link-prediction AUC {auc:.6f} ({time.perf_counter() - t0:.2f} s)")
    if not auc > 0.75:
        raise AssertionError(f"AUC {auc} <= 0.75")

    # 4. timing at the main path's inputs -------------------------------------
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
    source = "main-path batch"
    got = ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, w)
    want = ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, w)
    max_err = max(max_err, compare(torch, got, want, f"sgns_lifetime {source}"))
    ms = time_ms(torch, lambda: ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, w), 50)
    plain_ms = time_ms(torch, lambda: ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, w), 5)
    b_ms, b_by = bound_ms(torch, ctx, out, neg, valid, w)
    log(f"[time] sgns_lifetime on {source} (valid {valid.float().mean().item():.4f}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")

    print(json.dumps({"kernels": [{
        "name": "sgns_lifetime",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sgns/csrc/sgns_lifetime.cu",
        "replaces": "src/repro/kernels/sgns/kernel.py:121",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
