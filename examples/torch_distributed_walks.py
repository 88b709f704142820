"""Distributed information-centric walks on the PyTorch port: MPGP against
hash partitioning.

Shows the two §3 claims: constant-size InCoM messages (80 bytes), and the
cut in cross-shard messages from proximity-aware partitioning. The walks
run on the partition-sharded engine (``repro_torch.core.shard_engine``),
which counts every hand-off it exchanges.

  PYTHONPATH=src python examples/torch_distributed_walks.py               # on the GPU
  PYTHONPATH=src python examples/torch_distributed_walks.py --device cpu   # ~1 min
"""

import argparse

import torch

from repro_torch import prng
from repro_torch.core.mpgp import hash_partition, mpgp_partition
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import LaneKeys, WalkSpec, batch_stats, run_walk_batch
from repro_torch.graph.generators import rmat_graph


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    graph = rmat_graph(4096, 10, seed=1, device=args.device).with_edge_cm()
    machines = 4
    spec = WalkSpec(max_len=60, min_len=10, mu=0.995, info_mode="incom", reg_start=16)
    lanes = 1024
    sources = torch.arange(lanes, device=graph.device) % graph.num_nodes
    policy = make_policy("huge")

    for name, part in (
        ("MPGP (proximity-aware)", mpgp_partition(graph, machines, gamma=2.0).assignment),
        ("hash (locality-blind)", hash_partition(graph, machines).assignment),
    ):
        keys = LaneKeys.of([prng.PRNGKey(0)], lanes, lanes, graph.device)
        st = run_walk_batch(graph, sources, keys, policy, spec, part)
        stats = batch_stats(st)
        per_msg = stats["msg_bytes"] / max(stats["msg_count"], 1)
        print(f"{name:24s} crossings={stats['msg_count']:6d}  bytes/msg={per_msg:5.1f}  "
              f"mean_len={stats['mean_len']:.1f}  measured==analytic: "
              f"{stats['msg_bytes'] == stats['msg_bytes_analytic']}")

    print("\nInCoM message = 80 B constant (walker_id, steps, node, H, L, "
          "E(H), E(L), E(HL), E(H^2), E(L^2))")
    print("full-path message at L=60 would be 24 + 8*60 = 504 B")


if __name__ == "__main__":
    main()
