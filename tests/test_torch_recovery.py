"""Crash recovery of the port's streaming pipeline.

``tests/test_recovery.py``'s recipe (rmat 128, dim 16, HuGE with vertex
keys): a crash at every injection point of the run loop — a round, a walk
batch's ``superstep``, a tail iteration, a snapshot write, a torn snapshot,
several crashes in one run — is resumed from the newest valid snapshot under
``run_with_restarts``, and phi, the ring and ocn come out bit-equal to the
port's uninterrupted run (the oracle here is the port's own run, not the
reference test's assertions). A supervisor with more crashes planned than
restarts allowed gives up. A refresh that dies between splices is redone
from the pre-refresh snapshot bit for bit. (Resumes of the reference's
snapshots are in ``tests/test_torch_ckpt.py``.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.graph.generators import churn_batch, rmat_graph
from repro_torch.runtime.faults import (FaultInjector, NullInjector, SimulatedFailure,
                                        run_with_restarts)
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: Fixed-mode DeepWalk with short walks, for the refresh's crash.
FIXED_PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=4,
                  dim=16, seed=3, rng_mode="vertex")
FIXED_DSGL = dict(dim=16, seed=3, batch_groups=16)


def _plan(seed=3, dim=16):
    cfg = dataclasses.replace(EmbedConfig(dim=dim, seed=seed), rng_mode="vertex")
    policy, spec, rounds = make_walk_plan(cfg)
    return policy, spec, rounds, DSGLConfig(dim=dim, seed=seed)


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(128, 7, seed=7, device="cpu")


@pytest.fixture(scope="module")
def oracle(graph):
    """The uninterrupted run: the bit-identity target of every crash test."""
    p = StreamingEmbedPipeline(graph, *_plan())
    res = p.run()
    return {"pipe": p, "res": res}


def assert_same_run(want: StreamingEmbedPipeline, got: StreamingEmbedPipeline):
    assert torch.equal(want.phi_in, got.phi_in) and torch.equal(want.phi_out, got.phi_out)
    assert torch.equal(want.ring.walks, got.ring.walks)
    assert torch.equal(want.ring.ocn, got.ring.ocn)
    assert (want.global_step, want.controller.history) == (got.global_step,
                                                           got.controller.history)


def _run_with_crashes(graph, root, plan, torn_plan=None, max_restarts=8):
    """Supervise a run under an injection plan: crash -> resume from the
    newest valid snapshot (or start over without one) -> continue. Returns
    (pipeline, injector, restarts)."""
    policy, spec, rounds, dsgl = _plan()
    faults = FaultInjector(plan, torn_plan or {})
    state = {"p": StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl)}

    def attempt(i):
        return state["p"].run(ckpt_root=root, ckpt_every_rounds=1, faults=faults)

    def recover(i):
        try:
            state["p"] = StreamingEmbedPipeline.resume(root, policy, spec, dsgl, device="cpu")
        except FileNotFoundError:        # crashed before the first snapshot
            state["p"] = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl)

    _, restarts = run_with_restarts(attempt, recover=recover, max_restarts=max_restarts)
    return state["p"], faults, restarts


def test_save_resume_round_trip(oracle, tmp_path):
    p = oracle["pipe"]
    p._ckpt_seq = 0
    p.save(str(tmp_path))
    q = StreamingEmbedPipeline.resume(str(tmp_path), *_plan()[:2], _plan()[3], device="cpu")
    assert_same_run(p, q)
    assert (p.ring.cursor, p.ring.total) == (q.ring.cursor, q.ring.total)
    np.testing.assert_array_equal(p._slot_root, q._slot_root)
    np.testing.assert_array_equal(p._slot_round, q._slot_round)
    assert (p.key_walk, p.key_train) == (q.key_walk, q.key_train)
    assert (p._phase, p._trained_rounds, p._rounds_walked) == \
        (q._phase, q._trained_rounds, q._rounds_walked)
    assert p.stats()["accepts"] == q.stats()["accepts"]


@pytest.mark.parametrize("plan,torn,restarts,fired", [
    ({"round": [2]}, {}, 1, [("round", 2)]),              # at a round boundary
    ({"superstep": [5]}, {}, 1, [("superstep", 5)]),      # mid-round, nothing committed
    ({"tail": [1]}, {}, 1, [("tail", 1)]),                # between tail iterations
    ({"ckpt_write": [3]}, {}, 1, [("ckpt_write", 3)]),    # before a snapshot commits
    ({}, {"ckpt": [2]}, 1, []),                           # a torn snapshot: fall back one
    ({"round": [3], "superstep": [4], "tail": [2]}, {}, 3,
     [("round", 3), ("superstep", 4), ("tail", 2)]),      # several crashes, each reached
], ids=["round", "superstep", "tail", "ckpt_write", "torn_ckpt", "multi"])
def test_crash_replay_is_bit_identical(graph, oracle, tmp_path, plan, torn, restarts, fired):
    p, faults, n = _run_with_crashes(graph, str(tmp_path / "ckpt"), plan, torn)
    assert n == restarts and sorted(faults.fired) == sorted(fired) and faults.pending == 0
    assert_same_run(oracle["pipe"], p)


def test_crash_without_progress_exhausts_the_supervisor(graph, tmp_path):
    with pytest.raises(SimulatedFailure):
        _run_with_crashes(graph, str(tmp_path / "ckpt"), {"round": list(range(20))},
                          max_restarts=3)


def test_injector_fires_once_and_counts():
    f = FaultInjector({"round": [1]})
    f.fire("round")                       # occurrence 0: no fire
    with pytest.raises(SimulatedFailure):
        f.fire("round")                   # occurrence 1: fires
    f.fire("round")                       # occurrence 1 consumed
    assert f.counts["round"] == 3 and f.fired == [("round", 1)] and f.pending == 0
    null = NullInjector()
    null.fire("round")
    assert not null.torn("ckpt") and not null.inject("phi_nan")


def test_superstep_fires_once_per_walker_batch(graph):
    """The ``superstep`` point keeps the reference's cadence: once per
    ``walker_batch`` sources, whatever the port's batch size."""
    policy, spec, rounds, dsgl = _plan()
    p = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl, walker_batch=48)
    faults = FaultInjector()
    p._run_round(0, faults=faults)
    assert faults.counts["superstep"] == 3            # sources 0, 48, 96 of 128


def _fixed_plan():
    return (*make_walk_plan(EmbedConfig(**FIXED_PLAN)), DSGLConfig(**FIXED_DSGL))


def test_refresh_splice_crash_recovers_bit_identically(graph, tmp_path):
    """A refresh that dies after its first resident round's splices (the
    ring half old, half new) is redone from the pre-refresh snapshot: the
    same phi, ring and ocn as the refresh that was never interrupted."""
    from repro_torch.core.incremental import IncrementalRefresh

    policy, spec, rounds, dsgl = _fixed_plan()
    p = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl)
    p.run()
    root = str(tmp_path / "pre_refresh")
    p.save(root)
    batch = churn_batch(graph, 0.05, seed=11)
    q = StreamingEmbedPipeline.resume(root, policy, spec, dsgl, device="cpu")
    IncrementalRefresh(q).apply_updates(batch).refresh()
    with pytest.raises(SimulatedFailure):
        IncrementalRefresh(p).apply_updates(batch).refresh(
            faults=FaultInjector({"refresh_splice": [1]}))
    p2 = StreamingEmbedPipeline.resume(root, policy, spec, dsgl, device="cpu")
    IncrementalRefresh(p2).apply_updates(batch).refresh()
    assert_same_run(q, p2)
