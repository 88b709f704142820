"""Serving launcher CLI (batched prefill + decode over the runtime server).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 6 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
      --reduced --device cpu

The flags and defaults of the JAX package's ``launch/serve.py``, plus
``--device`` (the card by default; ``--device cpu`` with ``--reduced`` runs
on the CPU). The weights are random, drawn with seed 0.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--new-tokens", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import init_params, reduce_config
    from repro_torch.runtime.server import Request, Server, ServerConfig, \
        throughput_stats

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = init_params(cfg, seed=0, device=args.device)
    srv = Server(cfg, params, ServerConfig(batch_slots=args.slots,
                                           max_len=args.max_len), device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    done = srv.serve(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    print(json.dumps({"requests": len(done), "device": str(srv.device),
                      **throughput_stats(n_tok, dt)}))


if __name__ == "__main__":
    main()
