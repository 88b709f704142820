"""MPGP (``repro_torch.core.mpgp``) and the graph statistics against the
JAX package's: stream orders and every partitioner's assignment, locality
and balance bit for bit, on unweighted and weighted R-MAT graphs; the
per-arc common-neighbour counts the port's PS2 reads against the
reference's galloping intersections."""

import numpy as np
import pytest
import torch

from repro.core import mpgp as jax_mpgp
from repro.graph import stats as jax_stats
from repro.graph.generators import rmat_graph as jax_rmat_graph
from repro_torch.core import mpgp
from repro_torch.graph import stats
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

GRAPHS = {"rmat600": dict(num_nodes=600, avg_degree=6, seed=3),
          "rmat600w": dict(num_nodes=600, avg_degree=6, seed=4, weighted=True),
          "rmat2000": dict(num_nodes=2000, avg_degree=5, seed=0)}
_CACHE = {}


def _graphs(name):
    """(reference graph, port graph) built from the same seed."""
    if name not in _CACHE:
        kw = GRAPHS[name]
        _CACHE[name] = (jax_rmat_graph(**kw), rmat_graph(**kw, device="cpu"))
    return _CACHE[name]


def _same_result(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.assignment.dtype == want.assignment.dtype == np.int32
    assert (got.locality, got.balance) == (want.locality, want.balance)
    assert (got.num_parts, got.gamma, got.order) == (want.num_parts, want.gamma, want.order)
    np.testing.assert_array_equal(got.counts(), want.counts())


@pytest.mark.parametrize("order", ["random", "natural", "bfs", "dfs", "bfs+degree",
                                   "dfs+degree", "dfs+deg"])
@pytest.mark.parametrize("name", ["rmat600", "rmat2000"])
def test_stream_order_bit_exact(name, order):
    ref_g, g = _graphs(name)
    np.testing.assert_array_equal(mpgp.stream_order(g, order, seed=5),
                                  jax_mpgp.stream_order(ref_g, order, seed=5))


def test_unknown_stream_order_is_refused():
    with pytest.raises(ValueError, match="unknown stream order"):
        mpgp.stream_order(_graphs("rmat600")[1], "zigzag")


@pytest.mark.parametrize("name", ["rmat600", "rmat600w"])
def test_edge_cm_equals_galloping_intersections(name):
    """PS2 reads the graph's per-arc counts: each equals the reference's
    |N(v) ∩ N(u)| by galloping intersection."""
    ref_g, g = _graphs(name)
    host = mpgp.HostCSR.of(g, with_cm=True)
    ip, ix = np.asarray(ref_g.indptr), np.asarray(ref_g.indices)
    want = [jax_mpgp._intersect_count_sorted(ix[ip[v]:ip[v + 1]], ix[ip[u]:ip[u + 1]])
            for v in range(len(ip) - 1) for u in ix[ip[v]:ip[v + 1]]]
    np.testing.assert_array_equal(host.edge_cm, np.asarray(want))
    a, b = np.array([1, 3, 5, 9]), np.array([0, 3, 4, 5, 8, 9, 11])
    assert mpgp._intersect_count_sorted(a, b) == jax_mpgp._intersect_count_sorted(a, b) == 3


@pytest.mark.parametrize("kw", [
    dict(),
    dict(order="bfs+degree"),
    dict(tau_weight="degree"),
    dict(use_ps2=False),
    dict(gamma=1.1, order="random", seed=2),
], ids=["default", "bfs+degree", "tau-degree", "no-ps2", "gamma1.1-random"])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("name", ["rmat600", "rmat600w"])
def test_mpgp_partition_bit_exact(name, m, kw):
    ref_g, g = _graphs(name)
    _same_result(mpgp.mpgp_partition(g, m, **kw), jax_mpgp.mpgp_partition(ref_g, m, **kw))


def test_mpgp_partition_bit_exact_at_two_thousand_nodes():
    ref_g, g = _graphs("rmat2000")
    got, want = mpgp.mpgp_partition(g, 2), jax_mpgp.mpgp_partition(ref_g, 2)
    _same_result(got, want)
    print(f"rmat2000 k=2: port {got.seconds:.3f} s, reference {want.seconds:.3f} s")


@pytest.mark.parametrize("kw", [dict(), dict(num_segments=3, order="dfs+degree"),
                                dict(tau_weight="degree", use_ps2=False)])
@pytest.mark.parametrize("name", ["rmat600", "rmat600w"])
def test_mpgp_partition_parallel_bit_exact(name, kw):
    ref_g, g = _graphs(name)
    _same_result(mpgp.mpgp_partition_parallel(g, 4, **kw),
                 jax_mpgp.mpgp_partition_parallel(ref_g, 4, **kw))


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("name", ["rmat600", "rmat600w"])
def test_baseline_partitions_bit_exact(name, m):
    ref_g, g = _graphs(name)
    _same_result(mpgp.balanced_only_partition(g, m), jax_mpgp.balanced_only_partition(ref_g, m))
    _same_result(mpgp.hash_partition(g, m), jax_mpgp.hash_partition(ref_g, m))


def test_stream_restricted_to_allowed_parts_matches_reference():
    """``_assign_stream`` with an ``allowed`` mask and primed counts (the
    form the elastic helpers use) places the same nodes the same way."""
    ref_g, g = _graphs("rmat600")
    base = jax_mpgp.mpgp_partition(ref_g, 3).assignment
    nodes = np.flatnonzero(base == 1)
    want, got = base.copy(), base.copy()
    want[nodes] = got[nodes] = -1
    counts = np.bincount(want[want >= 0], minlength=3).astype(np.int64)
    allowed = np.array([True, False, True])
    c_want, c_got = counts.copy(), counts.copy()
    jax_mpgp._assign_stream(ref_g.to_numpy(), nodes, want, c_want, 3, 2.0, True, "nodes",
                            allowed=allowed)
    mpgp._assign_stream(mpgp.HostCSR.of(g, with_cm=True), nodes, got, c_got, 3, 2.0, True,
                        "nodes", allowed=allowed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(c_got, c_want)
    with pytest.raises(ValueError, match="unknown tau_weight"):
        mpgp._assign_stream(mpgp.HostCSR.of(g, with_cm=False), nodes, got, c_got, 3, 2.0,
                            False, "edges")


@pytest.mark.parametrize("name", ["rmat600", "rmat600w"])
def test_graph_stats_bit_exact(name):
    ref_g, g = _graphs(name)
    asg = np.random.default_rng(0).integers(0, 3, g.num_nodes).astype(np.int32)
    assert stats.edge_locality(g, asg) == jax_stats.edge_locality(ref_g, asg)
    assert stats.partition_balance(asg, 3) == jax_stats.partition_balance(asg, 3)
    np.testing.assert_array_equal(stats.degree_distribution(g),
                                  jax_stats.degree_distribution(ref_g))
    ocn = np.random.default_rng(1).integers(0, 50, g.num_nodes)
    np.testing.assert_array_equal(stats.occurrence_distribution(ocn),
                                  jax_stats.occurrence_distribution(ocn))
    p, q = stats.degree_distribution(g), stats.occurrence_distribution(ocn)
    assert stats.relative_entropy(p, q) == jax_stats.relative_entropy(p, q)
    deg = g.degrees().numpy()
    assert stats.powerlaw_alpha_mle(deg, 2) == jax_stats.powerlaw_alpha_mle(deg, 2)
