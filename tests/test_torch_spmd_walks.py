"""The walk engine across processes: ``run_walk_sharded(mesh=)`` with one
shard a rank over gloo, against the port's stacked engine (every field of
the merged state and the per-shard stats, bit for bit) and, for
fixed-mode DeepWalk walks, the stacked engine against the reference's.

One spawn of four ranks (``repro_torch.dist.spawn``) runs every case in
``CASES``, k = 2 on ranks 0-1, and each test asserts its own case. The
ranks import neither JAX nor the reference; the parent computes the
stacked and reference runs while they work.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from repro_torch.core import mpgp, shard_engine
from repro_torch.dist.spawn import run_ranks
from repro_torch.graph.generators import rmat_graph

torch.set_num_threads(1)

LANES = 128
FIXED = dict(max_len=12, info_mode="fixed", fixed_len=12)
# Walks of at most 12 steps: a collective over gloo costs milliseconds on a
# shared CPU, a superstep runs a few of them, and HuGE's rejections make
# ~8 supersteps a step.
HUGE = dict(max_len=12, min_len=6, mu=0.995, info_mode="incom", reg_start=6)
FULLPATH = dict(max_len=12, min_len=6, mu=-1.0, info_mode="fullpath", reg_start=6)
WINDOW = dict(max_len=12, min_len=6, mu=0.995, info_mode="incom", reg_window=4)
DEEPWALK = dict(graph="plain", policy="deepwalk", spec=FIXED, seed=5)
HUGE_CASE = dict(graph="medium", policy="huge", spec=HUGE, seed=11)
CASES = {
    "deepwalk replicated k=2": dict(DEEPWALK, k=2, engine="replicated"),
    "deepwalk replicated k=4": dict(DEEPWALK, k=4, engine="replicated"),
    "deepwalk local gather k=2": dict(DEEPWALK, k=2, engine="local", transport="gather",
                                      pool_factor=2.0, compact_every=1),
    "deepwalk local a2a k=2": dict(DEEPWALK, k=2, engine="local", transport="a2a",
                                   pool_factor=2.0, compact_every=1),
    "deepwalk local gather k=4": dict(DEEPWALK, k=4, engine="local", transport="gather",
                                      pool_factor=4.0, compact_every=2, exchange_cap=16),
    "deepwalk local a2a k=4": dict(DEEPWALK, k=4, engine="local", transport="a2a",
                                   pool_factor=4.0, compact_every=1, exchange_cap=8),
    # engine and transport left to the driver: local and a2a on a mesh,
    # which the stacked run is told explicitly
    "huge auto k=2": dict(HUGE_CASE, k=2, stacked=dict(engine="local", transport="a2a")),
    # a cap of 4 records spills; the default pool (gamma 2) overflows and grows
    "huge spill a2a k=4": dict(HUGE_CASE, k=4, engine="local", transport="a2a",
                               exchange_cap=4),
    "huge fullpath local gather k=4": dict(HUGE_CASE, k=4, engine="local", transport="gather",
                                           spec=FULLPATH),
    "huge window local a2a k=2": dict(HUGE_CASE, k=2, engine="local", transport="a2a",
                                      spec=WINDOW),
}
REFERENCE_CASES = [name for name in CASES if name.startswith("deepwalk")]


def _arrays(graph) -> dict:
    cm = None if graph.edge_cm is None else graph.edge_cm.numpy()
    return {"indptr": graph.indptr.numpy(), "indices": graph.indices.numpy(), "edge_cm": cm}


def _reference_runs(medium_graph, parts) -> dict:
    """The reference's stacked engine on the DeepWalk cases."""
    import jax
    import jax.numpy as jnp
    from repro.core import shard_engine as jax_shard_engine
    from repro.core.shard_engine import run_walk_sharded as jax_run
    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec

    jax_shard_engine._POOL_CACHE.clear()
    out = {}
    for name in REFERENCE_CASES:
        case = CASES[name]
        kw = {n: case[n] for n in ("engine", "transport", "exchange_cap", "pool_factor",
                                   "compact_every") if n in case}
        ref = jax_run(medium_graph, jnp.arange(LANES, dtype=jnp.int32),
                      jax.random.PRNGKey(case["seed"]), jax_make_policy(case["policy"]),
                      JaxWalkSpec(**case["spec"]), jnp.asarray(parts[case["k"]], jnp.int32),
                      case["k"], **kw)
        out[name] = {"path": np.asarray(ref.path), "L": np.asarray(ref.info.L),
                     "counts": (int(ref.supersteps), int(ref.accepts), int(ref.rejects),
                                int(ref.msg_count), float(ref.msg_bytes),
                                float(ref.msg_bytes_analytic))}
    return out


@pytest.fixture(scope="module")
def runs(medium_graph):
    """(stacked, SPMD per rank, reference) for every case: the ranks run
    while the parent computes the other two."""
    medium = rmat_graph(1024, 10, seed=3, device="cpu").with_edge_cm()
    plain = rmat_graph(1024, 10, seed=3, device="cpu")
    p4 = mpgp.mpgp_partition(medium, 4, gamma=2.0).assignment.astype(np.int64)
    parts = {2: p4 % 2, 4: p4}
    inputs = {"lanes": LANES, "parts": parts, "cases": CASES,
              "graphs": {"plain": _arrays(plain), "medium": _arrays(medium)}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spmd = pool.submit(run_ranks, ranks.walk_cases, 4, "gloo", "cpu", 150.0, inputs)
        saved = dict(shard_engine._POOL_CACHE)
        shard_engine._POOL_CACHE.clear()       # the ranks start with empty caches too
        try:
            graphs = ranks.graphs_of(inputs)
            stacked = {name: ranks.walk_case(graphs, inputs,
                                             dict(case, **case.get("stacked", {})), None)
                       for name, case in CASES.items()}
        finally:
            shard_engine._POOL_CACHE.clear()
            shard_engine._POOL_CACHE.update(saved)
        reference = _reference_runs(medium_graph, parts)
        return stacked, spmd.result(), reference


@pytest.mark.parametrize("name", list(CASES))
def test_spmd_walks_equal_stacked_run(runs, name):
    """Every rank of the case's mesh returns the stacked run's merged state
    (paths, lengths, info, h series and ring, accepts, rejects, hand-offs,
    bytes) and its per-shard stats, bit for bit."""
    stacked, spmd, _ = runs
    want, want_stats = stacked[name]
    k = CASES[name]["k"]
    assert [name in r["cases"] for r in spmd] == [r < k for r in range(4)]
    for rank in range(k):
        got, stats = spmd[rank]["cases"][name]
        assert got.keys() == want.keys()
        for field in want:
            np.testing.assert_array_equal(np.asarray(got[field]), np.asarray(want[field]),
                                          err_msg=f"rank {rank} {field}")
        assert stats == want_stats, rank
    if k > 1:
        assert int(want["msg_count"]) > 0


def test_mesh_defaults_pick_local_engine_and_a2a(runs):
    """``engine="auto"`` on a mesh is the local engine (its pool stats
    appear), and both paths counted their batches."""
    _, spmd, _ = runs
    got_stats = spmd[0]["cases"]["huge auto k=2"][1]
    assert "pool_slots" in got_stats and "exchange_rounds" in got_stats
    n_k2 = sum(CASES[name]["k"] == 2 for name in CASES)
    assert [r["spmd_batches"] for r in spmd] == [len(CASES)] * 2 + [len(CASES) - n_k2] * 2
    assert all(r["batches"] >= r["spmd_batches"] for r in spmd)


def test_spill_and_pool_growth_ran_on_the_mesh(runs):
    """The tiny-cap case spilled and the default-pool k = 4 case grew its
    pool: the shared host reads decided both on every rank alike."""
    _, spmd, _ = runs
    stats = spmd[0]["cases"]["huge spill a2a k=4"][1]
    assert stats["spill_rounds"] > 0 and stats["pool_retries"] >= 1


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_stacked_run_equals_reference(runs, name):
    """The port's stacked run of a DeepWalk case draws the reference's
    stacked walks and counts, bit for bit (so the SPMD run does too)."""
    stacked, _, reference = runs
    got, ref = stacked[name][0], reference[name]
    np.testing.assert_array_equal(got["path"], ref["path"])
    np.testing.assert_array_equal(got["info.L"], ref["L"])
    assert (got["supersteps"], int(got["accepts"]), int(got["rejects"]), int(got["msg_count"]),
            float(got["msg_bytes"]), float(got["msg_bytes_analytic"])) == ref["counts"]
