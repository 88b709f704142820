"""Quickstart for the PyTorch port: embed a graph with DistGER in a few lines.

  PYTHONPATH=src python examples/torch_quickstart.py               # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # ~1 min
"""

import argparse

import torch

from repro_torch.core.api import EmbedConfig, embed_graph
from repro_torch.graph.generators import rmat_graph


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nodes", type=int, default=2_000, help="R-MAT graph size")
    args = ap.parse_args()
    graph = rmat_graph(args.nodes, 10, seed=0, device=args.device)

    # Information-oriented random walks (HuGE termination) + DSGL learner,
    # partitioned across 2 shards with hotness-block synchronization.
    phi_in, phi_out, stats = embed_graph(
        graph,
        EmbedConfig(dim=64, epochs=1, lr=0.05, delta=1e-4, max_len=40, min_len=10),
        num_shards=2, return_stats=True, device=args.device,
    )

    print(f"graph: |V|={graph.num_nodes} |E|={graph.num_edges}")
    print(f"partition: {stats['part_counts']} nodes per shard, locality "
          f"{stats['locality']:.3f}; {stats['steps']} training steps, "
          f"{stats['syncs']} hotness syncs")
    print(f"embeddings: {tuple(phi_in.shape)}, norm μ="
          f"{phi_in.norm(dim=1).mean().item():.3f}")
    # nearest neighbours of node 0 in embedding space
    sims = phi_in @ phi_in[0]
    top = torch.argsort(-sims)[1:6]
    print(f"nearest neighbors of node 0: {top.tolist()}")


if __name__ == "__main__":
    main()
