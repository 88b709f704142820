"""Training launcher CLI.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --steps 20 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --distger --device cpu

The flags and defaults of the JAX package's ``launch/train.py``, plus
``--device`` (the card by default). ``--distger`` trains graph embeddings
(the paper's workload, ``core.api.embed_graph``) instead of an LM. The
checkpoint directory defaults to one under the system's temporary
directory. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--reduced", action="store_true",
                   help="CPU-smoke config of the same family")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--distger", action="store_true",
                   help="run the paper's graph-embedding workload instead")
    p.add_argument("--graph-nodes", type=int, default=2000)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.distger:
        from repro_torch.configs.distger import PAPER_EMBED
        from repro_torch.core.api import embed_graph
        from repro_torch.graph.generators import rmat_graph
        g = rmat_graph(args.graph_nodes, 10, seed=0, device=args.device)
        t0 = time.time()
        phi_in, _ = embed_graph(g, PAPER_EMBED, num_shards=args.shards, device=args.device)
        print(json.dumps({"nodes": g.num_nodes, "edges": g.num_edges,
                          "dim": int(phi_in.shape[1]),
                          "seconds": round(time.time() - t0, 2)}))
        return

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import reduce_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, batch=args.batch, seq_len=args.seq)
    out = Trainer(cfg, tcfg, device=args.device).run_with_restarts()
    last = out["metrics"][-1] if out["metrics"] else {}
    print(json.dumps({"final_step": out["final_step"],
                      "restarts": out["restarts"],
                      "last_loss": last.get("loss"),
                      "straggler_stats": out["straggler_stats"]}))


if __name__ == "__main__":
    main()
