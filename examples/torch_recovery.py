"""Crash, resume and heal the port's streaming pipeline on a small graph.

  PYTHONPATH=src python examples/torch_recovery.py                 # on the GPU
  PYTHONPATH=src python examples/torch_recovery.py --device cpu    # ~1 min

Runs ``embed_graph``'s pipeline (MPGP, two replicas) once straight through,
then again under ``run_with_restarts`` with a crash at a round, a torn
snapshot and a crash at a tail iteration, resuming each time from the
newest valid snapshot: the two runs' phi must be bit-equal. Then a NaN is
injected into phi from the newest tail snapshot and the watchdog rolls the
run back and finishes it at half the learning rate. Telemetry is on; the
flight records of the fired faults and the run's counters are printed.
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import read_meta, valid_steps
from repro_torch.configs.distger import GRAPH_PRESETS
from repro_torch.core.api import EmbedConfig, dsgl_config, make_walk_plan
from repro_torch.core.mpgp import mpgp_partition
from repro_torch.eval import link_prediction_auc
from repro_torch.graph.generators import rmat_graph
from repro_torch.runtime.faults import FaultInjector, run_with_restarts
from repro_torch.runtime.health import HealthConfig, HealthMonitor
from repro_torch.runtime.trainer import StreamingEmbedPipeline


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--preset", default="small", choices=sorted(GRAPH_PRESETS))
    ap.add_argument("--check-every", type=int, default=4,
                    help="global steps between the watchdog's checks")
    args = ap.parse_args()
    preset = GRAPH_PRESETS[args.preset]
    graph = rmat_graph(preset.num_nodes, preset.avg_degree, seed=0,
                       device=args.device).with_edge_cm()
    cfg = EmbedConfig(dim=64, epochs=1, lr=0.05, max_len=40, min_len=10)
    policy, spec, rounds = make_walk_plan(cfg)
    dsgl = dsgl_config(cfg)
    assignment = mpgp_partition(graph, 2).assignment
    build = lambda **kw: StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl,
                                                assignment=assignment, num_shards=2, **kw)
    t0 = time.perf_counter()
    straight = build().run()
    print(f"{preset.name}: |V|={graph.num_nodes}; uninterrupted run {straight['rounds']} "
          f"rounds, {straight['steps']} steps in {time.perf_counter() - t0:.2f} s")

    tmp = tempfile.mkdtemp(prefix="torch_recovery_")
    root, flight = os.path.join(tmp, "ckpt"), os.path.join(tmp, "flight")
    try:
        with obs.override(enabled=True, flight_dir=flight):
            faults = FaultInjector({"round": [2], "tail": [1]}, torn_plan={"ckpt": [1]})
            health = HealthMonitor(HealthConfig(check_every=args.check_every))
            state = {"p": build(health=health)}

            def recover(i):
                state["p"] = StreamingEmbedPipeline.resume(root, policy, spec, dsgl,
                                                           health=health, device=args.device)
                print(f"  restart {i}: resumed at step {state['p'].global_step} "
                      f"({state['p']._phase})")

            t0 = time.perf_counter()
            _, restarts = run_with_restarts(
                lambda i: state["p"].run(ckpt_root=root, ckpt_every_rounds=2, ckpt_keep=3,
                                         faults=faults), recover=recover)
            same = all(torch.equal(a, b) for a, b in zip(state["p"].embeddings(),
                                                         (straight["phi_in"],
                                                          straight["phi_out"])))
            print(f"crashed run: {restarts} restarts, faults fired {faults.fired}, "
                  f"{time.perf_counter() - t0:.2f} s; phi equal to the uninterrupted run's: "
                  f"{same}; flight records {sorted(os.listdir(flight))}")

            metas = {s: read_meta(root, s)[1] for s in valid_steps(root)}
            tails = [s for s, m in metas.items()
                     if m["phase"] == "tail" and m["global_step"] < m["total_steps"]]
            if not tails:
                print("no tail snapshot with steps left: no heal drill")
                return
            heal_root = os.path.join(tmp, "heal")
            os.makedirs(heal_root)
            name = f"step_{max(tails):08d}"
            os.rename(os.path.join(root, name), os.path.join(heal_root, name))
            q = StreamingEmbedPipeline.resume(
                heal_root, policy, spec, dsgl, device=args.device,
                health=HealthMonitor(HealthConfig(check_every=args.check_every)))
            start = q.global_step
            heal = q.run(ckpt_root=heal_root, faults=FaultInjector(inject_plan={"phi_nan": [0]}))
            phi_in, _ = q.embeddings()
            auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
            found = [d.step for d in q.health.detections]
            print(f"heal drill from step {start}: {heal['health']['detection_kinds']} at steps "
                  f"{found}, {heal['health']['rollbacks']} rollback, lr scale "
                  f"{heal['lr_scale']}, phi finite {bool(torch.isfinite(phi_in).all())}, "
                  f"AUC {auc:.4f}")
            counters = obs.REGISTRY.snapshot()["counters"]
            print("counters:", {k: v for k, v in sorted(counters.items())
                                if not k.startswith("walk.")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
