"""Dynamic graphs on the PyTorch port: embed, churn, refresh incrementally.

Builds an R-MAT graph, embeds it with the streaming pipeline
(``embed_graph(..., return_state=True)``: vertex-keyed walks), applies a
localized batch of edge inserts and deletes through the delta-CSR overlay
and absorbs it with ``refresh_embedding`` (affected vertices read off the
corpus ring, their walks walked again and spliced into their slots, the
seeded ΔD gate, an in-place DSGL fine-tune). Prints the affected fraction,
the extra rounds, and the link-prediction AUC on the mutated graph of the
stale and of the refreshed embedding.

``--preset NAME`` embeds a ``GRAPH_PRESETS`` stand-in under ``PAPER_EMBED``
in place of the small recipe graph. ``--scratch`` also embeds the mutated
graph from scratch (vertex keys) and prints its AUC; ``--lane`` adds a
from-scratch run under lane keys; ``--same-graph`` embeds the unmutated
graph again through the from-scratch call and says whether its phi equals
the base run's bit for bit. ``--epochs`` takes several values and repeats
the whole sequence for each, on the same graph and churn batch.

  PYTHONPATH=src python examples/torch_incremental_updates.py [--device cpu] [--nodes 2048]
  PYTHONPATH=src python examples/torch_incremental_updates.py --preset fl-sim --scratch \\
      --epochs 1 4
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.distger import GRAPH_PRESETS, PAPER_EMBED
from repro_torch.core.api import EmbedConfig, embed_graph, refresh_embedding
from repro_torch.eval import link_prediction_auc
from repro_torch.graph.generators import churn_batch, rmat_graph


def auc(graph, phi) -> float:
    return link_prediction_auc(graph, phi, np.random.default_rng(7))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--preset", default=None, help="a GRAPH_PRESETS name, under PAPER_EMBED")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--churn", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, nargs="+", default=[1])
    ap.add_argument("--scratch", action="store_true")
    ap.add_argument("--lane", action="store_true")
    ap.add_argument("--same-graph", action="store_true")
    args = ap.parse_args()

    if args.preset:
        preset = GRAPH_PRESETS[args.preset]
        graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=args.seed,
                           device=args.device)
        base_cfg = dataclasses.replace(PAPER_EMBED, seed=args.seed)
    else:
        graph = rmat_graph(args.nodes, 10, seed=args.seed, device=args.device)
        base_cfg = EmbedConfig(dim=args.dim, epochs=1, lr=0.05, delta=1e-3, max_len=40,
                               min_len=10, window=6, negatives=4, seed=args.seed)
    if args.shards > 1:              # one Cm for every run on this graph
        graph = graph.with_edge_cm()
    batch = churn_batch(graph, args.churn, seed=args.seed + 1)
    print(f"|V|={graph.num_nodes}  |E|={graph.num_edges // 2}  churn: +{len(batch.insert)} / "
          f"-{len(batch.delete)} edges ({100 * args.churn:.1f}% of |E|)", flush=True)

    for epochs in args.epochs:
        cfg = dataclasses.replace(base_cfg, epochs=epochs)
        t0 = time.perf_counter()
        phi0, _, state = embed_graph(graph, cfg, num_shards=args.shards, return_state=True,
                                     device=args.device)
        pipe = state.refresher.pipeline
        print(f"[epochs {epochs}] embed: rounds {pipe.controller.rounds}, steps "
              f"{pipe.global_step}, AUC on the graph {auc(graph, phi0):.6f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if args.same_graph:
            phi_v, _ = embed_graph(graph, dataclasses.replace(cfg, rng_mode="vertex"),
                                   num_shards=args.shards, device=args.device)
            print(f"[epochs {epochs}] from scratch on the same graph: phi equals the embed's "
                  f"bit for bit {torch.equal(phi_v, phi0)}, AUC {auc(graph, phi_v):.6f}",
                  flush=True)

        phi1, _, stats = refresh_embedding(state, batch)
        print(f"[epochs {epochs}] refresh: affected {stats.affected} vertices "
              f"({100 * stats.affected_frac:.1f}% of |V|), {stats.retained_rounds} retained "
              f"rounds re-walked, {stats.extra_rounds} extra rounds, {stats.rewalk_supersteps} "
              f"re-walk supersteps, {stats.fine_tune_steps} fine-tune steps, "
              f"{stats.wall_s:.1f} s", flush=True)

        mutated = state.graph
        line = (f"[epochs {epochs}] link-prediction AUC on the mutated graph: stale "
                f"{auc(mutated, phi0):.6f} -> refreshed {auc(mutated, phi1):.6f}")
        if args.scratch:
            phi_s, _ = embed_graph(mutated, dataclasses.replace(cfg, rng_mode="vertex"),
                                   num_shards=args.shards, device=args.device)
            line += f", scratch {auc(mutated, phi_s):.6f}"
        if args.lane:
            phi_l, _ = embed_graph(mutated, dataclasses.replace(cfg, rng_mode="lane"),
                                   num_shards=args.shards, device=args.device)
            line += f", scratch under lane keys {auc(mutated, phi_l):.6f}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
