"""Time the DSGL step's kernels (K1 and its write-back) on the card against
other builds of them, on batches of the embedding path's own traffic.

    PYTHONPATH=src python3 -m repro_torch.kernels.sgns.bench [DIR ...]

Each DIR holds an edited copy of this kernel's ``csrc/`` directory (a
variant, named by DIR, or by its parent when DIR is called ``csrc``; for
example under ``build/dev/``, which ``.gitignore`` lists). It is built
beside the port's own kernel and timed in turns with it (every build, then
every build again in reverse order), so that versions are compared within
one run on one card. A copy of the atomic write-back that the fixed-order
one replaced (the source before it, whose lifetime kernel counts
duplicates and whose write-back adds with float atomics and then clears
the counts) is recognised by its ``sgns_writeback_launch`` and driven
through that interface:

    mkdir -p build/dev/atomic/csrc && git show \
      dc4bc21:src/repro_torch/kernels/sgns/csrc/sgns_lifetime.cu \
      > build/dev/atomic/csrc/sgns_lifetime.cu

The batches are what a training step of the embedding path gets:
``embed_graph(PAPER_EMBED, num_shards=2)`` runs once on yt-sim, as
``chip_smoke.py`` runs it, and BATCHES batches of S = 2 replicas x G = 64
lifetimes of W = 2 walks are picked at random from its corpus (as
``chip_smoke.py`` picks its main-path batch), with negatives drawn from the
corpus's counts and the run's embeddings as both replicas. A launch lasts
as long as its longest lifetime, so each batch's largest extent
(positions visited) is printed, and K1's times are also given per
position of it. Per batch and build it prints K1 alone and the whole step
(K1 and the write-back); their difference is the write-back's cost. The
port's kernel is checked against ``ref.lifetime_deltas_ref`` on every
batch first (5e-4; the variants are timed, not checked).

Last, the two places a chunk's hotness sync can run, in turns on a
50-step chunk of the run's walks and the rows of one sync of its hotness
blocks: after the chunk's graph replay, or captured at the end of the
graph, from a static rows buffer (the port's choice,
``core.dsgl.ChunkGraphs``). Needs a CUDA device; the embedding run takes about a
minute and a half on an H100.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

TOL = 5e-4
BATCHES = 8
LR = 0.025


def _time_ms(torch, fn, reps: int = 40) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up call."""
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


def _declare_any(lib) -> None:
    """The port's interface, or the atomic write-back's (its lifetime launch
    takes two count pointers more, and it has ``sgns_writeback_launch``)."""
    from repro_torch.kernels.sgns import ops

    if not hasattr(lib, "sgns_writeback_launch"):
        ops._declare(lib)
        return
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sgns_init.restype = i32
    lib.sgns_lifetime_launch.argtypes = [ptr] * 5 + [i64, i32] + [ptr] * 7 + [i32] * 6 + [ptr]
    lib.sgns_lifetime_launch.restype = i32
    lib.sgns_writeback_launch.argtypes = [ptr] * 9 + [i32] * 6 + [i64, ptr]
    lib.sgns_writeback_launch.restype = i32
    if lib.sgns_init() != 0:
        raise RuntimeError("sgns library init failed")


def _atomic_fns(torch, lib, phi_in, phi_out, walks, negs, lr, window, scratch):
    """(K1 alone, the whole step) through the atomic write-back's interface."""
    s_cnt, n_rows, _ = phi_in.shape
    _, g_cnt, w_cnt, t_len = walks.shape
    k, dim = negs.shape[-1], phi_in.shape[-1]
    cnt = torch.zeros(2, s_cnt * n_rows, device=phi_in.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def lifetimes(counts):
        err = lib.sgns_lifetime_launch(
            phi_in.data_ptr(), phi_out.data_ptr(), phi_out.data_ptr(), walks.data_ptr(),
            negs.data_ptr(), n_rows, g_cnt, scratch.d_ctx.data_ptr(), scratch.d_out.data_ptr(),
            scratch.d_neg.data_ptr(), scratch.loss.data_ptr(),
            cnt[0].data_ptr() if counts else None, cnt[1].data_ptr() if counts else None,
            lr.data_ptr(), s_cnt * g_cnt, w_cnt, t_len, dim, k, window, stream())
        assert err == 0, err

    def step():
        lifetimes(True)
        err = lib.sgns_writeback_launch(
            phi_in.data_ptr(), phi_out.data_ptr(), walks.data_ptr(), negs.data_ptr(),
            scratch.d_ctx.data_ptr(), scratch.d_out.data_ptr(), scratch.d_neg.data_ptr(),
            cnt[0].data_ptr(), cnt[1].data_ptr(), s_cnt * g_cnt, w_cnt, t_len, dim, k, g_cnt,
            n_rows, stream())
        assert err == 0, err

    return (lambda: lifetimes(False)), step


def _sync_variants(torch, np, phi_in, phi_out, corpus, table, window, k) -> None:
    """Time a 50-step chunk replayed as a CUDA graph with its hotness sync
    run after the replay, and with the sync captured in the graph, in
    turns (after, in graph, in graph, after)."""
    from repro_torch.core import dsgl
    from repro_torch.core.corpus import FrequencyOrder
    from repro_torch.core.sync import hotness_sync_stacked, sample_hotness_rows
    from repro_torch.kernels.sgns import ops

    c_cnt, (s_cnt, _, d) = 50, phi_in.shape
    g_cnt, w_cnt, t_len = dsgl.DSGLConfig().batch_groups, 2, corpus.walks.shape[1]
    rng = np.random.default_rng(4)
    walks = torch.as_tensor(corpus.walks[rng.choice(
        corpus.num_walks, c_cnt * s_cnt * g_cnt * w_cnt, replace=False)], device="cuda").reshape(
        c_cnt, s_cnt, g_cnt, w_cnt, t_len)
    negs = dsgl.chunk_negatives(table, (0, 9), walks.shape, k)
    order = FrequencyOrder.from_ocn(corpus.ocn)
    rows = torch.as_tensor(order.to_node[sample_hotness_rows(
        *order.hotness_blocks(), rng)].astype(np.int64), device="cuda")
    lrs = torch.linspace(0.025, 0.02, c_cnt, device="cuda")
    phi = [phi_in.clone(), phi_out.clone()]
    held = []

    def capture(with_sync: bool):
        scratch = ops.StepScratch.empty(walks.shape[1:], k, d, "cuda")
        loss = torch.empty(c_cnt, s_cnt * g_cnt, device="cuda")
        held.append((scratch, loss))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for c in range(c_cnt):
                ops.launch_step(*phi, walks[c], negs[c], lrs[c:c + 1], window,
                                dataclasses.replace(scratch, loss=loss[c]))
            if with_sync:
                hotness_sync_stacked(*phi, rows)
        return graph

    plain, synced = capture(False), capture(True)
    run = {"after the replay": lambda: (plain.replay(), hotness_sync_stacked(*phi, rows)),
           "inside the graph": synced.replay}
    times = {}
    for name in ["after the replay", "inside the graph", "inside the graph",
                 "after the replay"]:
        times.setdefault(name, []).append(_time_ms(torch, run[name], reps=10))
    alone = _time_ms(torch, plain.replay, reps=10)
    print(f"[sync] a {c_cnt}-step chunk (S = {s_cnt}) with the sync of {len(rows)} hotness "
          "rows: " + ", ".join(f"sync {name} {t[0]:.4f} / {t[1]:.4f} ms"
                               for name, t in times.items())
          + f"; the chunk without a sync {alone:.4f} ms", flush=True)


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    from repro_torch.configs.distger import GRAPH_PRESETS, PAPER_EMBED
    from repro_torch.core import dsgl
    from repro_torch.core.api import embed_graph
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.sgns import ops, ref

    if not torch.cuda.is_available():
        print("sgns.bench: needs a CUDA device", file=sys.stderr)
        return 1
    builds = {"port": ops.LIBRARY}
    for arg in argv:
        d = Path(arg)
        name = d.parent.name if d.name == "csrc" else d.name
        builds[name] = CudaLibrary(f"sgns_{name}", d / "sgns_lifetime.cu", _declare_any)
    build_all(builds.values())
    for name, lib in builds.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    cfg = PAPER_EMBED
    g_cnt, w_cnt, k, window = (dsgl.DSGLConfig().batch_groups, cfg.multi_windows,
                               cfg.negatives, cfg.window)
    preset = GRAPH_PRESETS["yt-sim"]
    graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0, device="cuda")
    phi_in, phi_out, corpus = embed_graph(graph, cfg, num_shards=2, return_corpus=True,
                                          device="cuda")
    phi_in, phi_out = torch.stack([phi_in, phi_in]), torch.stack([phi_out, phi_out])
    print(f"[corpus] {preset.name}: {corpus.num_walks} walks, mean length "
          f"{corpus.lengths.mean():.4f}", flush=True)
    lr = torch.full((1,), LR, device="cuda")
    table = dsgl.build_alias_table(corpus.ocn, dsgl.DSGLConfig().neg_power, "cuda")
    rng = np.random.default_rng(9)
    t_len = corpus.walks.shape[1]
    batches = []
    for b in range(BATCHES):
        pick = rng.choice(corpus.num_walks, 2 * g_cnt * w_cnt, replace=False)
        walks = torch.as_tensor(corpus.walks[pick], device="cuda").reshape(
            2, g_cnt, w_cnt, t_len)
        negs = dsgl.chunk_negatives(table, (0, b), (1, 2, g_cnt, w_cnt, t_len), k)[0]
        batches.append((walks, negs))

    for b, (walks, negs) in enumerate(batches):
        got = ops.lifetime_deltas(phi_in, phi_out, walks, negs, lr, window)
        want = ref.lifetime_deltas_ref(phi_in, phi_out, walks, negs, lr, window)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item()
                  for x, y in zip((got.d_ctx, got.d_out, got.d_neg), want[:3]))
        if err > TOL:
            raise AssertionError(f"K1 on batch {b} differs by {err:.3e}")
    print(f"[check] port K1 on {BATCHES} batches: within {TOL}", flush=True)

    port = ops.LIBRARY
    per_build = {name: {"k1": [], "step": []} for name in builds}
    for b, (walks, negs) in enumerate(batches):
        lo, hi = ref.lifetime_extent(walks)
        extent = int(torch.where(hi >= 0, hi - lo + 1, 0).max())
        scratch = ops.StepScratch.empty(walks.shape, k, cfg.dim, "cuda")
        fns = {}
        for name, lib in builds.items():
            if hasattr(lib.load(), "sgns_writeback_launch"):
                fns[name] = _atomic_fns(torch, lib.load(), phi_in, phi_out, walks, negs, lr,
                                        window, scratch)
            else:
                def k1(lib=lib):
                    ops.LIBRARY = lib
                    ops.lifetime_deltas(phi_in, phi_out, walks, negs, lr, window,
                                        scratch=scratch)

                def step(lib=lib):
                    ops.LIBRARY = lib
                    ops.launch_step(phi_in, phi_out, walks, negs, lr, window, scratch)
                fns[name] = (k1, step)
        times = {}
        try:
            for name in [*builds, *reversed(builds)]:
                for i, what in enumerate(("k1", "step")):
                    times.setdefault(name, {}).setdefault(what, []).append(
                        _time_ms(torch, fns[name][i]))
        finally:
            ops.LIBRARY = port
        for name, t in times.items():
            for what in ("k1", "step"):
                per_build[name][what].append(min(t[what]))
        print(f"[time] batch {b} (valid tokens {(walks >= 0).float().mean().item():.4f}, "
              f"largest extent {extent}): " + "; ".join(
                  f"{name} K1 {t['k1'][0]:.4f} / {t['k1'][1]:.4f} ms "
                  f"({min(t['k1']) / extent * 1e3:.2f} us per position), step "
                  f"{t['step'][0]:.4f} / {t['step'][1]:.4f} ms, write-back "
                  f"{min(t['step']) - min(t['k1']):.4f} ms" for name, t in times.items()),
              flush=True)
    for name, t in per_build.items():
        k1, step = np.asarray(t["k1"]), np.asarray(t["step"])
        rel = k1 / np.asarray(per_build["port"]["k1"])
        print(f"[summary] {name}: K1 median {np.median(k1):.4f} ms over {BATCHES} batches "
              f"({rel.min():.3f}-{rel.max():.3f}x the port's); step median "
              f"{np.median(step):.4f} ms; write-back (step - K1) median "
              f"{np.median(step - k1):.4f} ms", flush=True)
    _sync_variants(torch, np, phi_in, phi_out, corpus, table, window, k)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
