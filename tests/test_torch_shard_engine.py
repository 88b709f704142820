"""The port's partition-sharded walk engine against the JAX reference: the
partitioned CSR, the stacked collectives, the replicated engine, the
fullpath and reg_window modes, and the pipeline's message counts.

Walks whose acceptance and termination use no transcendental function
(DeepWalk and node2vec with ``info_mode="fixed"``) are compared with the
reference's bit for bit. HuGE + InCoM walks are compared with the port's
dense engine bit for bit, and with the reference by distribution (torch and
XLA round ``tanh`` and ``log2`` differently in the last bits). The
reference is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import incom, mpgp
from repro_torch.core import walker as wk
from repro_torch.core.shard_engine import run_walk_sharded
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import LaneKeys, WalkSpec, run_walk_batch
from repro_torch.graph.csr import build_csr, build_partitioned_csr, subgraph_partition_pad
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

INFO = ("H", "L", "EH", "EL", "EHL", "EH2", "EL2")
FIXED = dict(max_len=24, info_mode="fixed", fixed_len=24)
HUGE = dict(max_len=40, min_len=8, mu=0.995, info_mode="incom", reg_start=16)
LANES = 128


@pytest.fixture(scope="module")
def medium():
    return rmat_graph(1024, 10, seed=3, device="cpu").with_edge_cm()


@pytest.fixture(scope="module")
def parts(medium):
    p4 = mpgp.mpgp_partition(medium, 4, gamma=2.0).assignment.astype(np.int64)
    n = medium.num_nodes
    return {1: np.zeros(n, np.int64), 2: p4 % 2, 4: p4, 8: np.arange(n) % 8}


def keys_of(seed, lanes=LANES):
    return LaneKeys.of([prng.PRNGKey(seed)], lanes, lanes, "cpu")


def hops(paths: np.ndarray, part: np.ndarray) -> int:
    """Consecutive path entries whose owners differ: the hand-offs a walk makes."""
    a, b = paths[:, :-1], paths[:, 1:]
    ok = (a >= 0) & (b >= 0)
    return int((ok & (part[np.maximum(a, 0)] != part[np.maximum(b, 0)])).sum())


def assert_same_walks(got, want, what=""):
    np.testing.assert_array_equal(got.path.numpy(), want.path.numpy(), err_msg=what)
    for f in INFO:
        np.testing.assert_array_equal(getattr(got.info, f).numpy(),
                                      getattr(want.info, f).numpy(), err_msg=f"{what} {f}")
    assert (got.supersteps, int(got.accepts), int(got.rejects)) == \
        (want.supersteps, int(want.accepts), int(want.rejects)), what


# --- the partitioned CSR ------------------------------------------------------


def _weighted_pair(seed):
    from repro.graph.csr import build_csr as jax_build_csr
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, 300, (1500, 2))
    w = rng.random(1500).astype(np.float32) + 0.5
    return jax_build_csr(edges, 300, weights=w), build_csr(edges, 300, weights=w, device="cpu")


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["mpgp", "random", "weighted"])
def test_partitioned_csr_matches_reference(medium_graph, medium, k, kind):
    from repro.graph.csr import build_partitioned_csr as jax_build

    if kind == "weighted":
        ref_graph, graph = _weighted_pair(k)
        asn = np.random.default_rng(k).integers(0, k, graph.num_nodes)
    else:
        ref_graph, graph = medium_graph.with_edge_cm(), medium
        asn = (mpgp.mpgp_partition(graph, k).assignment if kind == "mpgp"
               else np.random.default_rng(k).integers(0, k, graph.num_nodes))
    ref, got = jax_build(ref_graph, asn, k), build_partitioned_csr(graph, asn, k)
    for name in ("indptr", "indices", "nbr_owner", "nbr_deg", "weights", "edge_cm"):
        want = getattr(ref.slices, name)
        if want is None:
            assert getattr(got.slices, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(got.slices, name).numpy(), np.asarray(want),
                                      err_msg=name)
    np.testing.assert_array_equal(got.local_of.numpy(), np.asarray(ref.local_of))
    np.testing.assert_array_equal(got.owned, ref.owned)
    np.testing.assert_array_equal(got.num_owned, ref.num_owned)
    np.testing.assert_array_equal(got.shard_csr_nbytes(), ref.shard_csr_nbytes())
    from repro.graph.csr import subgraph_partition_pad as jax_pad
    for a, b in zip(subgraph_partition_pad(graph, asn, k), jax_pad(ref_graph, asn, k)):
        np.testing.assert_array_equal(a, b)


# --- the collectives, against the reference's under jax.vmap -------------------


def _vmapped(fn):
    import jax
    return jax.vmap(fn, axis_name="s")


@pytest.mark.parametrize("k,p,cap", [(3, 40, 5), (4, 64, 64)])
def test_packed_collectives_match_reference(k, p, cap):
    """cap below the pending count leaves lanes pending (a spill round)."""
    import jax.numpy as jnp
    from repro.dist import collectives as jc
    from repro_torch.dist import collectives as tc

    rng = np.random.default_rng(k * 100 + p)
    pay = {"i": rng.integers(-5, 1000, (k, p, 3)).astype(np.int32),
           "f": rng.standard_normal((k, p, 7)).astype(np.float32)}
    pending = rng.random((k, p)) < 0.6
    dest = rng.integers(0, k, (k, p)).astype(np.int32)
    jpay = {n: jnp.asarray(x) for n, x in pay.items()}
    tpay = {n: torch.from_numpy(x) for n, x in pay.items()}

    ref = _vmapped(lambda x, m: jc.packed_all_gather(x, m, cap, "s"))(jpay, jnp.asarray(pending))
    got = tc.packed_all_gather(tpay, torch.from_numpy(pending), cap)
    assert int(np.asarray(ref[2]).sum()) < pending.sum() or cap >= p
    for s in range(k):                   # every shard sees the same gathered records
        for n in pay:
            np.testing.assert_array_equal(np.asarray(ref[0][n][s]), got[0][n].numpy())
        np.testing.assert_array_equal(np.asarray(ref[1][s]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), got[2].numpy())

    ref = _vmapped(lambda x, d, m: jc.packed_all_to_all(x, d, m, k, cap, "s"))(
        jpay, jnp.asarray(dest), jnp.asarray(pending))
    got = tc.packed_all_to_all(tpay, torch.from_numpy(dest), torch.from_numpy(pending), k, cap)
    for n in pay:
        np.testing.assert_array_equal(np.asarray(ref[0][n]), got[0][n].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), got[2].numpy())

    ref = _vmapped(lambda x, m: jc.take_ranked(x, m, cap))(jpay, jnp.asarray(pending))
    got = tc.take_ranked(tpay, torch.from_numpy(pending), cap)
    for n in pay:
        np.testing.assert_array_equal(np.asarray(ref[0][n]), got[0][n].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())

    # Queries a lower bound exists for (past csum[-1] the reference's
    # bisection overshoots, and every caller clips).
    csum = np.cumsum(pending, 1).astype(np.int32)
    np.testing.assert_array_equal(tc.row_cumsum(torch.from_numpy(pending)).numpy(), csum)
    queries = (rng.random((k, 17)) * (csum[:, -1:] + 1)).astype(np.int32)
    ref = _vmapped(jc.rank_search)(jnp.asarray(csum), jnp.asarray(queries))
    got = tc.rank_search(torch.from_numpy(csum), torch.from_numpy(queries))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())

    owner = rng.integers(0, k, p)                  # at most one sender a lane
    mask = owner[None, :] == np.arange(k)[:, None]
    ref = _vmapped(lambda x, m: jc.psum_union(x, m, "s"))(jpay, jnp.asarray(mask))
    got = tc.psum_union(tpay, torch.from_numpy(mask))
    for n in pay:
        np.testing.assert_array_equal(np.asarray(ref[n][0]), got[n].numpy())


# --- fixed-mode walks, replicated engine, against the reference ---------------


@pytest.mark.parametrize("method,k", [("deepwalk", 1), ("deepwalk", 2), ("deepwalk", 4),
                                      ("deepwalk", 8), ("node2vec", 2), ("node2vec", 4)])
def test_replicated_engine_matches_reference(medium_graph, medium, parts, method, k):
    import jax
    import jax.numpy as jnp
    from repro.core.shard_engine import run_walk_sharded as jax_run
    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec

    part = parts[k]
    ref = jax_run(medium_graph, jnp.arange(LANES, dtype=jnp.int32), jax.random.PRNGKey(5),
                  jax_make_policy(method, p=2.0, q=0.5), JaxWalkSpec(**FIXED),
                  jnp.asarray(part, jnp.int32), k, engine="replicated")
    got = run_walk_sharded(medium, torch.arange(LANES), keys_of(5),
                           make_policy(method, p=2.0, q=0.5), WalkSpec(**FIXED), part, k,
                           engine="replicated")
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.info.L.numpy(), np.asarray(ref.info.L))
    assert (got.supersteps, int(got.accepts), int(got.rejects)) == \
        (int(ref.supersteps), int(ref.accepts), int(ref.rejects))
    assert int(got.msg_count) == int(ref.msg_count) == hops(got.path.numpy(), part)
    assert float(got.msg_bytes) == float(ref.msg_bytes)
    assert float(got.msg_bytes_analytic) == float(ref.msg_bytes_analytic)
    assert (int(got.msg_count) > 0) == (k > 1)


def test_node2vec_cannot_run_partition_local(medium, parts):
    with pytest.raises(ValueError, match="cannot run partition-local"):
        run_walk_sharded(medium, torch.arange(LANES), keys_of(5), make_policy("node2vec"),
                         WalkSpec(**FIXED), parts[2], 2, engine="local")


# --- HuGE + InCoM: the replicated engine against the port's dense engine -------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_replicated_huge_walks_equal_dense_engine(medium, parts, k):
    spec = WalkSpec(**HUGE)
    dense = run_walk_batch(medium, torch.arange(LANES), keys_of(11), make_policy("huge"), spec)
    got = run_walk_batch(medium, torch.arange(LANES), keys_of(11), make_policy("huge"), spec,
                         parts[k], num_shards=k)
    assert_same_walks(got, dense, f"k={k}")
    assert int(got.msg_count) == hops(got.path.numpy(), parts[k])
    assert float(got.msg_bytes) == float(got.msg_bytes_analytic) == \
        incom.MSG_BYTES * int(got.msg_count)


def test_handoffs_per_step_match_reference_by_distribution(medium_graph, medium, parts):
    """HuGE + InCoM at k = 4 on 256 walks: the port's hand-offs per
    accepted step within 2% of the reference's. Walks diverge only where
    last-bit differences of tanh / log2 flip a decision; the measured gap
    is below 1e-6 (0.509837 both)."""
    import jax
    import jax.numpy as jnp
    from repro.core.shard_engine import run_walk_sharded as jax_run
    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec

    lanes = 256
    ref = jax_run(medium_graph.with_edge_cm(), jnp.arange(lanes, dtype=jnp.int32),
                  jax.random.PRNGKey(2), jax_make_policy("huge"), JaxWalkSpec(**HUGE),
                  jnp.asarray(parts[4], jnp.int32), 4, engine="replicated")
    got = run_walk_sharded(medium, torch.arange(lanes), keys_of(2, lanes), make_policy("huge"),
                           WalkSpec(**HUGE), parts[4], 4, engine="replicated")
    rate_ref = int(ref.msg_count) / int(ref.accepts)
    rate = int(got.msg_count) / int(got.accepts)
    print(f"hand-offs per accepted step: port {rate:.6f}, reference {rate_ref:.6f}")
    assert abs(rate - rate_ref) <= 0.02 * rate_ref, (rate, rate_ref)
    assert float(got.msg_bytes) == float(got.msg_bytes_analytic)


# --- fullpath and reg_window -----------------------------------------------------


def test_fullpath_and_window_statistics_within_a_few_ulp():
    import jax.numpy as jnp
    from repro.core import incom as jax_incom
    from repro.core import walker as jax_walker

    rng = np.random.default_rng(4)
    b, max_len = 512, 32
    length = rng.integers(1, max_len + 1, b)
    path = rng.integers(0, 12, (b, max_len)).astype(np.int32)
    path[np.arange(max_len)[None, :] >= length[:, None]] = -1
    want = np.asarray(jax_walker._fullpath_entropy(jnp.asarray(path),
                                                   jnp.asarray(length, jnp.int32)))
    got = wk._fullpath_entropy(torch.from_numpy(path), torch.from_numpy(length)).numpy()
    # 32 log2 terms, each of which may differ in its last bit, summed in
    # another order: 5 ULP measured.
    np.testing.assert_array_max_ulp(got, want, maxulp=8)

    # Entropies on a 1/8 grid keep every sum exact in float32, whatever the
    # order of summation, so the statistics' own arithmetic is compared.
    h = np.cumsum(rng.integers(0, 3, (b, max_len)), 1).astype(np.float32) / 8
    for window, start in ((0, 1), (6, 1), (0, 16)):
        want = np.asarray(jax_walker._fullpath_r2(jnp.asarray(h), jnp.asarray(length, jnp.int32),
                                                  window, start))
        got = wk._fullpath_r2(torch.from_numpy(h), torch.from_numpy(length), window,
                              start).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=4)

    ring = rng.integers(0, 32, (b, 6)).astype(np.float32) / 8
    L = rng.integers(1, 60, b).astype(np.float32)
    want = np.asarray(jax_incom.windowed_r_squared(jnp.asarray(ring), jnp.asarray(L), 6))
    got = incom.windowed_r_squared(torch.from_numpy(ring), torch.from_numpy(L), 6).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    assert (got > 0).mean() > 0.5


@pytest.mark.parametrize("engine", ["replicated", "local"])
def test_fullpath_and_window_message_costs(medium, parts, engine):
    """fullpath ships 24 + 8L bytes a hand-off (measured from the routed
    path, equal to the analytic sum); reg_window ships 80 + 8K. Both equal
    the dense engine's walks."""
    for spec, each in ((WalkSpec(max_len=32, min_len=8, mu=-1.0, info_mode="fullpath",
                                 reg_start=16), None),
                       (WalkSpec(max_len=32, min_len=8, mu=0.995, info_mode="incom",
                                 reg_window=6), incom.MSG_BYTES + 8 * 6)):
        dense = run_walk_batch(medium, torch.arange(LANES), keys_of(7), make_policy("huge"), spec)
        got = run_walk_sharded(medium, torch.arange(LANES), keys_of(7), make_policy("huge"),
                               spec, parts[4], 4, engine=engine)
        assert_same_walks(got, dense, spec.info_mode)
        np.testing.assert_array_equal(got.h_series.numpy(), dense.h_series.numpy())
        np.testing.assert_array_equal(got.hring.numpy(), dense.hring.numpy())
        count = int(got.msg_count)
        assert count == hops(got.path.numpy(), parts[4]) > 0
        assert float(got.msg_bytes) == float(got.msg_bytes_analytic)
        if each is None:             # each hand-off ships the walk, accepted node included
            assert float(got.msg_bytes) > 24 * count + 8 * 2 * count
        else:
            assert float(got.msg_bytes) == each * count


# --- the samplers and the pipeline ---------------------------------------------


def test_sample_corpus_with_partition_matches_reference(small_graph):
    """``sample_corpus(graph, cfg, part)``: the reference's corpus and its
    message totals, under a hash partition (every walk crosses)."""
    from repro.core.api import EmbedConfig as JaxEmbedConfig
    from repro.core.api import sample_corpus as jax_sample_corpus
    from repro_torch.core.api import EmbedConfig, sample_corpus

    graph = rmat_graph(256, 8, seed=7, device="cpu")
    part = mpgp.hash_partition(graph, 2).assignment
    kw = dict(method="deepwalk", info_termination=False, fixed_len=16, fixed_rounds=2, seed=4)
    ref = jax_sample_corpus(small_graph, JaxEmbedConfig(**kw), part=part)
    got = sample_corpus(graph, EmbedConfig(**kw), part, device="cpu")
    np.testing.assert_array_equal(ref.walks, got.walks)
    np.testing.assert_array_equal(ref.ocn, got.ocn)
    for name in ("supersteps", "accepts", "rejects", "msg_count", "msg_bytes",
                 "msg_bytes_analytic"):
        assert ref.stats[name] == got.stats[name], name
    assert got.stats["msg_count"] == hops(got.walks, part) > 0


@pytest.mark.parametrize("partitioner", ["mpgp_partition", "hash_partition"])
def test_embed_graph_message_totals_match_reference_pipeline(small_graph, monkeypatch,
                                                             partitioner):
    """``embed_graph(num_shards=2)`` in fixed mode walks through the sharded
    engine: its run's message totals are the reference pipeline's under the
    same assignment (MPGP's, and a hash partition's, which embed_graph is
    made to use here)."""
    from repro.core.dsgl import DSGLConfig as JaxDSGLConfig
    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec
    from repro.runtime.trainer import StreamingEmbedPipeline as JaxPipeline
    from repro_torch.core.api import EmbedConfig, embed_graph
    import repro_torch.core.shard_engine as se

    graph = rmat_graph(256, 8, seed=7, device="cpu")
    partition = getattr(mpgp, partitioner)
    part = partition(graph, 2).assignment
    monkeypatch.setattr(mpgp, "mpgp_partition", lambda g, k: partition(g, k))
    calls = []
    monkeypatch.setattr(se, "_run_replicated",
                        lambda *a, _f=se._run_replicated: calls.append(1) or _f(*a))
    cfg = EmbedConfig(method="deepwalk", info_termination=False, fixed_len=12, fixed_rounds=2,
                      dim=8, seed=3)
    _, _, stats = embed_graph(graph, cfg, num_shards=2, return_stats=True, device="cpu")
    assert len(calls) == stats["rounds"] == 2          # every round on the sharded engine

    spec = JaxWalkSpec(max_len=12, info_mode="fixed", fixed_len=12)
    ref = JaxPipeline(small_graph, jax_make_policy("deepwalk"), spec,
                      dict(delta=-1.0, min_rounds=2, max_rounds=2), JaxDSGLConfig(dim=8, seed=3),
                      assignment=part, num_shards=2)
    for r in range(2):
        ref._append(ref._run_round(r), r)
    ws = stats["stats"]
    assert ws["msg_count"] == int(ref._stats["msg_count"])
    assert ws["msg_bytes"] == float(ref._stats["msg_bytes"])
    assert ws["msg_bytes"] == ws["msg_bytes_analytic"] == incom.MSG_BYTES * ws["msg_count"]
    assert (ws["msg_count"] > 0) == (partitioner == "hash_partition")


def test_distributed_walks_example_runs_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    # One intra-op thread: under several test workers torch's spinning pool
    # made this run ~30x slower.
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(root / "examples" / "torch_distributed_walks.py"),
                           "--device", "cpu"], env=env, cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [l for l in proc.stdout.splitlines() if "crossings=" in l]
    assert len(lines) == 2 and all("bytes/msg= 80.0" in l and l.endswith("True") for l in lines)
    mpgp_x, hash_x = (int(l.split("crossings=")[1].split()[0]) for l in lines)
    assert 0 < mpgp_x < hash_x
