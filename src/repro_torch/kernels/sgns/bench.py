"""Time the SGNS lifetime kernel (K1) on the card against other builds of
it, on lifetime batches of the embedding path's own traffic.

    PYTHONPATH=src python3 -m repro_torch.kernels.sgns.bench [DIR ...]

Each DIR holds an edited copy of this kernel's ``csrc/`` directory (a
variant, named by DIR, or by its parent when DIR is called ``csrc``; for
example under ``build/dev/``, which ``.gitignore`` lists). It is built
beside the port's own kernel and timed in turns with it (every build, then
every build again in reverse order), so that versions are compared within
one run on one card.

The batches are what a training step of the embedding path gets:
``embed_graph(PAPER_EMBED)`` runs once on yt-sim, as ``chip_smoke.py``
runs it, and BATCHES batches of G = 64 lifetimes of W = 2 walks are
picked at random from its corpus (as ``chip_smoke.py`` picks its
main-path batch), with negatives drawn from the corpus's counts and the
run's embeddings as phi. A launch lasts as long as its longest lifetime,
so each batch's largest extent (positions visited) is printed, and times
are also given per position of it. The port's kernel is checked against
``ref.lifetime_deltas_ref`` on every batch first (5e-4; the variants are
timed, not checked). Needs a CUDA device; the embedding run takes about
a minute and a half on an H100.
"""

from __future__ import annotations

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
        builds[name] = CudaLibrary(f"sgns_{name}", d / "sgns_lifetime.cu", ops._declare)
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
    phi_in, phi_out, corpus = embed_graph(graph, cfg, return_corpus=True, device="cuda")
    phi_in, phi_out = phi_in[None], phi_out[None]
    print(f"[corpus] {preset.name}: {corpus.num_walks} walks, mean length "
          f"{corpus.lengths.mean():.4f}", flush=True)
    lr = torch.full((1,), LR, device="cuda")
    table = dsgl.build_alias_table(corpus.ocn, dsgl.DSGLConfig().neg_power, "cuda")
    rng = np.random.default_rng(9)
    t_len = corpus.walks.shape[1]
    batches = []
    for b in range(BATCHES):
        pick = rng.choice(corpus.num_walks, g_cnt * w_cnt, replace=False)
        walks = torch.as_tensor(corpus.walks[pick], device="cuda").reshape(
            1, g_cnt, w_cnt, t_len)
        negs = dsgl.chunk_negatives(table, (0, b), (1, 1, g_cnt, w_cnt, t_len), k)[0]
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
    per_build = {name: [] for name in builds}
    for b, (walks, negs) in enumerate(batches):
        lo, hi = ref.lifetime_extent(walks)
        extent = int(torch.where(hi >= 0, hi - lo + 1, 0).max())
        scratch = ops.StepScratch.empty(walks.shape, k, cfg.dim, "cuda")
        times = {}
        try:
            for name in [*builds, *reversed(builds)]:
                ops.LIBRARY = builds[name]
                times.setdefault(name, []).append(_time_ms(torch, lambda: ops.lifetime_deltas(
                    phi_in, phi_out, walks, negs, lr, window, scratch=scratch)))
        finally:
            ops.LIBRARY = port
        for name, t in times.items():
            per_build[name].append(min(t))
        print(f"[time] batch {b} (valid tokens {(walks >= 0).float().mean().item():.4f}, "
              f"largest extent {extent}): " + ", ".join(
                  f"{name} {t[0]:.4f} / {t[1]:.4f} ms ({min(t) / extent * 1e3:.2f} us per "
                  "position)" for name, t in times.items()), flush=True)
    for name, t in per_build.items():
        rel = np.asarray(t) / np.asarray(per_build["port"])
        print(f"[summary] {name}: median {np.median(t):.4f} ms over {BATCHES} batches, "
              f"{rel.min():.3f}-{rel.max():.3f}x the port's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
