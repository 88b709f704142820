"""Dynamic graphs on the port against the JAX reference: the delta-CSR
overlay, the incremental Cm, churn, vertex-keyed walks and subset re-walks,
affected-vertex detection, the ring splice, the seeded ΔD gate, the
pipeline's refresh and the API around it.

Integer work (the overlay, Cm, masks, fixed-mode walks, the ring and ocn)
is held bit for bit. HuGE walks are held within the port bit for bit and
against the reference by distribution (torch and XLA round ``log2`` and
``tanh`` differently in the last bits); phi by AUC. The reference is
imported inside the CPU tests that use it, so the ``cuda`` tests at the end
run without JAX taking the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.core import incom
from repro_torch.core.api import EmbedConfig, embed_graph, make_walk_plan, refresh_embedding
from repro_torch.core.corpus import CorpusRing, ring_append, ring_replace
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.core.incremental import IncrementalRefresh, affected_roots
from repro_torch.core.shard_engine import partitioned_csr_for, run_walk_sharded
from repro_torch.core.termination import WalkCountController
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import VertexKeys, WalkSpec, run_walk_batch
from repro_torch.eval import link_prediction_auc
from repro_torch.graph.csr import CSRGraph, build_csr, edge_common_neighbors
from repro_torch.graph.delta import (DeltaCSR, EdgeBatch, bump_graph_version, graph_version,
                                     validate_edge_batch)
from repro_torch.graph.generators import churn_batch, rmat_graph, undirected_edges
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

HUGE = dict(max_len=24, min_len=6, mu=0.995, info_mode="incom", reg_start=16,
            rng_mode="vertex")
FIXED = dict(max_len=16, info_mode="fixed", fixed_len=16, rng_mode="vertex")
SMALL_CFG = EmbedConfig(dim=8, epochs=1, max_len=16, min_len=4, window=3, negatives=2,
                        delta=1e-2)


def port_graph(ref_graph) -> CSRGraph:
    """The reference's graph as a port CSRGraph on the CPU."""
    g = ref_graph.to_numpy()
    t = lambda a, dt: None if a is None else torch.from_numpy(np.array(a, dt))
    return CSRGraph(t(g.indptr, np.int64), t(g.indices, np.int64), t(g.weights, np.float32),
                    t(g.edge_cm, np.int32))


def assert_same_graph(ref_graph, got: CSRGraph, what=""):
    g = ref_graph.to_numpy()
    np.testing.assert_array_equal(np.asarray(g.indptr), got.indptr.numpy(), err_msg=what)
    np.testing.assert_array_equal(np.asarray(g.indices), got.indices.numpy(), err_msg=what)
    for name in ("weights", "edge_cm"):
        want, have = getattr(g, name), getattr(got, name)
        assert (want is None) == (have is None), (what, name)
        if want is not None:
            np.testing.assert_array_equal(np.asarray(want), have.numpy(), err_msg=what)


def cpu_keys(seed, sources):
    return VertexKeys(prng.PRNGKey(seed), sources)


# ---------------------------------------------------------------------------
# (a) the overlay, batch by batch, against the reference's
# ---------------------------------------------------------------------------

def _base(n=48, m=160, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    w = rng.uniform(1.0, 5.0, m).astype(np.float32) if weighted else None
    return edges, w, n


def _case_batches(case, und, n, rng):
    """The churn batches of one overlay case (host numpy, both packages)."""
    pick = lambda k: und[rng.choice(len(und), k, replace=False)]
    rand = lambda k: np.stack([rng.integers(0, n, k), rng.integers(0, n, k)], 1)
    if case == "inserts_and_deletes":             # self-loops and present edges among them
        return [dict(insert=rand(12), delete=pick(8))]
    if case == "duplicates":
        e = rand(1)
        return [dict(insert=np.concatenate([und[:3], e, e, e[:, ::-1]])),
                dict(insert=np.concatenate([e, rand(3)]))]
    if case == "resurrection_with_new_weights":
        e = pick(3)
        return [dict(delete=e), dict(insert=e, insert_weights=np.array([7.5, 0.25, 3.0])),
                dict(insert=rand(4), insert_weights=np.full(4, 2.0)), dict(delete=rand(4))]
    if case == "out_of_range_deletes":            # 0 n + (n + 7) would alias a real arc's code
        return [dict(delete=np.array([[0, n + 7], [n + 2, 1], [3, 2 * n]])),
                dict(delete=pick(2))]
    if case == "vertex_growth":
        return [dict(insert=np.array([[2, n + 5], [n + 1, n + 3]])), dict(delete=pick(3)),
                dict(insert=np.array([[n + 5, 0]]))]
    if case == "auto_compaction":
        return [dict(delete=pick(10)), dict(insert=rand(6)), dict(delete=rand(5))]
    if case == "many_batches":
        return [dict(insert=rand(5), delete=pick(4)) for _ in range(5)]
    raise ValueError(case)


OVERLAY_CASES = [("inserts_and_deletes", False, True, 0.0),
                 ("duplicates", False, True, 0.0),
                 ("resurrection_with_new_weights", True, False, 0.0),
                 ("out_of_range_deletes", False, True, 0.0),
                 ("vertex_growth", False, True, 0.0),
                 ("auto_compaction", False, True, 0.01),
                 ("many_batches", True, False, 0.05)]


@pytest.mark.parametrize("case,weighted,with_cm,threshold", OVERLAY_CASES,
                         ids=[c[0] for c in OVERLAY_CASES])
def test_overlay_matches_reference_batch_by_batch(case, weighted, with_cm, threshold):
    from repro.graph.csr import build_csr as jax_build_csr
    from repro.graph.delta import DeltaCSR as JaxDelta
    from repro.graph.delta import EdgeBatch as JaxBatch
    from repro.graph.generators import undirected_edges as jax_und

    edges, w, n = _base(weighted=weighted)
    ref_g = jax_build_csr(edges, n, weights=w)
    got_g = build_csr(edges, n, weights=w, device="cpu")
    if with_cm:
        ref_g, got_g = ref_g.with_edge_cm(), got_g.with_edge_cm()
    assert_same_graph(ref_g, got_g, "base")
    ref = JaxDelta(ref_g, compact_threshold=threshold)
    got = DeltaCSR(got_g, compact_threshold=threshold)
    und = jax_und(ref_g)
    np.testing.assert_array_equal(und, undirected_edges(got_g))
    for i, b in enumerate(_case_batches(case, und, n, np.random.default_rng(1))):
        ref.apply_batch(JaxBatch(**b))
        got.apply_batch(EdgeBatch(**b))
        assert_same_graph(ref.graph(), got.graph(), f"{case} batch {i}")
        assert (got.num_nodes, got.pending_arcs, got.compactions, got.version) == \
            (ref.num_nodes, ref.pending_arcs, ref.compactions, ref.version)
    if case == "auto_compaction":
        assert got.compactions >= 1
    for want, have in zip(ref.take_changes(), got.take_changes()):
        np.testing.assert_array_equal(want, have)
    np.testing.assert_array_equal(ref.touched_nodes(), got.touched_nodes())
    np.testing.assert_array_equal(got.compact().indices.numpy(),
                                  np.asarray(ref.compact().to_numpy().indices))


@pytest.mark.parametrize("self_loops,duplicates", [("drop", "drop"), ("allow", "allow"),
                                                   ("drop", "allow")])
def test_validate_edge_batch_matches_reference(self_loops, duplicates):
    from repro.graph.delta import EdgeBatch as JaxBatch
    from repro.graph.delta import validate_edge_batch as jax_validate

    ins = np.array([[1, 2], [3, 3], [2, 1], [4, 5], [1, 2]])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    dele = np.array([[0, 0], [6, 7]])
    want = jax_validate(JaxBatch(insert=ins, delete=dele, insert_weights=w), 10,
                        self_loops=self_loops, duplicates=duplicates)
    got = validate_edge_batch(EdgeBatch(insert=ins, delete=dele, insert_weights=w), 10,
                              self_loops=self_loops, duplicates=duplicates)
    for name in ("insert", "delete", "insert_weights"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name))
    for bad in (EdgeBatch(insert=np.array([[0, 10]])),
                EdgeBatch(insert=ins, insert_weights=w[:2]),
                EdgeBatch(insert=ins[:1], insert_weights=np.array([np.nan]))):
        with pytest.raises(ValueError):
            validate_edge_batch(bad, 10)
    with pytest.raises(ValueError, match="forbid"):
        validate_edge_batch(EdgeBatch(insert=ins), 10, duplicates="forbid")


def test_version_bumps_retire_a_view():
    edges, _, n = _base()
    d = DeltaCSR(build_csr(edges, n, device="cpu"), compact_threshold=0)
    v1 = d.graph()
    assert graph_version(v1) == 0 and d.graph() is v1
    d.apply_batch(EdgeBatch(insert=np.array([[1, 2]])))
    assert graph_version(v1) > 0                 # the retired view's keys go stale
    v2 = d.graph()
    assert v2 is not v1 and graph_version(v2) == 0


# ---------------------------------------------------------------------------
# (b) the incremental Cm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1 << 25, 4096])
def test_incremental_cm_matches_reference_and_full_recount(medium_graph, chunk):
    from repro.graph.delta import DeltaCSR as JaxDelta
    from repro.graph.generators import churn_batch as jax_churn

    ref_g = medium_graph.with_edge_cm()
    got_g = port_graph(ref_g)
    ref_d, got_d = JaxDelta(ref_g, compact_threshold=0), DeltaCSR(got_g, compact_threshold=0)
    ref_d.apply_batch(jax_churn(ref_g, 0.05, seed=4))
    got_d.apply_batch(churn_batch(got_g, 0.05, seed=4))
    want, got = ref_d.graph(), got_d.graph()
    assert_same_graph(want, got, "merged view with Cm")
    full = edge_common_neighbors(got, wedge_chunk=chunk)
    assert torch.equal(got.edge_cm, full)
    # The subset form counts the same arcs as the full pass.
    arcs = torch.tensor([0, 5, 17, got.num_edges - 1, 5])
    assert torch.equal(edge_common_neighbors(got, wedge_chunk=chunk, arcs=arcs), full[arcs])


# ---------------------------------------------------------------------------
# (c) churn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac,seed", [(0.05, 1), (0.02, 2)])
def test_churn_batch_gives_the_reference_edges(medium_graph, frac, seed):
    from repro.graph.generators import churn_batch as jax_churn

    want = jax_churn(medium_graph, frac, seed=seed)
    got = churn_batch(port_graph(medium_graph), frac, seed=seed)
    np.testing.assert_array_equal(want.insert, got.insert)
    np.testing.assert_array_equal(want.delete, got.delete)
    assert got.num_changes >= int(0.9 * frac * medium_graph.num_edges / 2)


# ---------------------------------------------------------------------------
# (d) vertex-keyed uniforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,steps", [(11, (0, 1, 2, 63)), (3, (64, 65, 700, 4095))])
def test_vertex_uniforms_equal_reference_bit_for_bit(seed, steps):
    import jax
    import jax.numpy as jnp
    from repro.core.walker import WalkSpec as JaxSpec
    from repro.core.walker import make_uniform_fn

    src = np.array([0, 5, 3, 70_000, 7, 5, 2**31 - 1, 123_456], np.int32)
    fn = make_uniform_fn(JaxSpec(rng_mode="vertex"), jnp.asarray(src))
    keys = cpu_keys(seed, torch.from_numpy(src.astype(np.int64)))
    for t in steps:
        want = [np.asarray(u).view(np.uint32) for u in fn(jax.random.PRNGKey(seed), t)]
        got = [u.numpy().view(np.uint32) for u in keys.uniforms(t)]
        np.testing.assert_array_equal(want[0], got[0])
        np.testing.assert_array_equal(want[1], got[1])
    u = keys.uniforms(9)[0].numpy()
    assert u[1] == u[5]                          # the same source draws the same


# ---------------------------------------------------------------------------
# (e) subset re-walks and vertex-keyed walks
# ---------------------------------------------------------------------------

def _walk(graph, sources, policy, spec, engine, k, part):
    keys = cpu_keys(11, sources)
    if engine == "dense":
        return run_walk_batch(graph, sources, keys, policy, spec)
    return run_walk_sharded(graph, sources, keys, policy, spec, part, k, engine=engine)


# node2vec reads the previous node's row, which a partition-local shard lacks.
SUBSET_RUNS = [(e, k, m) for e, k in (("dense", 1), ("replicated", 3), ("local", 3))
               for m in ("huge", "deepwalk", "node2vec") if (e, m) != ("local", "node2vec")]


@pytest.mark.parametrize("engine,k,method", SUBSET_RUNS)
def test_subset_rewalk_equals_full_batch_rows(small_graph, engine, k, method):
    graph = port_graph(small_graph).with_edge_cm()
    n = graph.num_nodes
    policy = make_policy(method, p=0.5, q=2.0)
    spec = WalkSpec(**(HUGE if method == "huge" else FIXED))
    part = np.arange(n) % k
    full = _walk(graph, torch.arange(n), policy, spec, engine, k, part)
    ids = torch.tensor([200, 1, 7, 60, 130, 255, 7])     # any order, a duplicate
    sub = _walk(graph, ids, policy, spec, engine, k, part)
    assert torch.equal(sub.path, full.path[ids])
    assert torch.equal(sub.info.L, full.info.L[ids])
    if engine != "dense":
        dense = _walk(graph, torch.arange(n), policy, spec, "dense", 1, None)
        assert torch.equal(full.path, dense.path)


@pytest.mark.parametrize("method", ["deepwalk", "node2vec"])
def test_vertex_keyed_fixed_walks_equal_reference(small_graph, method):
    import jax
    import jax.numpy as jnp
    from repro.core.transition import make_policy as jax_policy
    from repro.core.walker import WalkSpec as JaxSpec
    from repro.core.walker import run_walk_batch as jax_walk

    n = small_graph.num_nodes
    ids = np.array([9, 3, 3, 250, 0, 128], np.int32)
    for sources in (np.arange(n, dtype=np.int32), ids):
        want = jax_walk(small_graph, jnp.asarray(sources), jax.random.PRNGKey(11),
                        jax_policy(method, p=0.5, q=2.0), JaxSpec(**FIXED))
        got = run_walk_batch(port_graph(small_graph), torch.from_numpy(sources.astype(np.int64)),
                             cpu_keys(11, torch.from_numpy(sources.astype(np.int64))),
                             make_policy(method, p=0.5, q=2.0), WalkSpec(**FIXED))
        np.testing.assert_array_equal(np.asarray(want.path), got.path.numpy())
        assert int(want.accepts) == int(got.accepts)


@pytest.mark.parametrize("walker_batch", [4096, 100])
def test_vertex_keyed_corpus_equals_reference(small_graph, walker_batch):
    """``generate_corpus`` walks every chunk of a vertex-keyed round under
    the round key, so the reference's chunk width does not matter."""
    from repro.core.corpus import generate_corpus as jax_corpus
    from repro.core.transition import make_policy as jax_policy
    from repro.core.walker import WalkSpec as JaxSpec
    from repro_torch.core.corpus import generate_corpus

    kw = dict(delta=-1.0, min_rounds=3, max_rounds=3, seed=5)
    want = jax_corpus(small_graph, policy=jax_policy("deepwalk"), spec=JaxSpec(**FIXED),
                      walker_batch=walker_batch, **kw)
    got = generate_corpus(port_graph(small_graph), policy=make_policy("deepwalk"),
                          spec=WalkSpec(**FIXED), **kw)
    np.testing.assert_array_equal(want.walks, got.walks)
    np.testing.assert_array_equal(want.ocn, got.ocn)


def test_vertex_keyed_huge_walks_match_reference_by_distribution(medium_graph):
    import jax
    import jax.numpy as jnp
    from repro.core.info import relative_entropy_dpq
    from repro.core.transition import make_policy as jax_policy
    from repro.core.walker import WalkSpec as JaxSpec
    from repro.core.walker import run_walk_batch as jax_walk

    g = medium_graph.with_edge_cm()
    n = g.num_nodes
    want = jax_walk(g, jnp.arange(n, dtype=jnp.int32), jax.random.PRNGKey(5),
                    jax_policy("huge"), JaxSpec(**HUGE))
    got = run_walk_batch(port_graph(g), torch.arange(n), cpu_keys(5, torch.arange(n)),
                         make_policy("huge"), WalkSpec(**HUGE))
    occ = lambda p: np.bincount(p[p >= 0], minlength=n)
    w, h = np.asarray(want.path), got.path.numpy()
    assert relative_entropy_dpq(occ(w), occ(h)) < 0.01
    assert abs(float(np.asarray(want.info.L).mean()) - float(got.info.L.mean())) < 0.5
    assert (w == h).all(axis=1).mean() > 0.5     # most walks are the same walk


# ---------------------------------------------------------------------------
# (f) affected-vertex detection
# ---------------------------------------------------------------------------

def _numpy_walks(indptr, indices, n, count, length, seed):
    """Random walks on the host, -1 padded where a walk reaches a dead end."""
    rng = np.random.default_rng(seed)
    deg = np.diff(indptr)
    cur = rng.integers(0, n, count)
    walks = np.full((count, length), -1, np.int64)
    walks[:, 0] = cur
    alive = np.ones(count, bool)
    for t in range(1, length):
        alive &= deg[cur] > 0
        j = (rng.random(count) * np.maximum(deg[cur], 1)).astype(np.int64)
        nxt = indices[np.minimum(indptr[cur] + j, len(indices) - 1)]
        cur = np.where(alive, nxt, cur)
        walks[alive, t] = cur[alive]
    return walks.astype(np.int32), walks[:, 0]


@pytest.fixture(scope="module")
def wide_graphs():
    """50,000 nodes: |V|² passes 2³¹, where the reference takes its host route."""
    from repro.graph.generators import rmat_graph as jax_rmat

    ref = jax_rmat(50_000, 3, seed=5)
    return ref, port_graph(ref)


@pytest.mark.parametrize("mode", ["traversal", "paranoid"])
@pytest.mark.parametrize("which", ["small", "wide"])
def test_affected_roots_match_reference(small_graph, wide_graphs, which, mode):
    from repro.core.incremental import affected_roots as jax_affected
    from repro.graph.delta import DeltaCSR as JaxDelta
    from repro.graph.generators import churn_batch as jax_churn

    ref_g, got_g = (small_graph, port_graph(small_graph)) if which == "small" else wide_graphs
    n = ref_g.num_nodes
    assert (n * n >= 2**31) == (which == "wide")
    walks, roots = _numpy_walks(got_g.indptr.numpy(), got_g.indices.numpy(), n,
                                2_000 if which == "small" else 20_000, 20, seed=2)
    batch = jax_churn(ref_g, 0.05, seed=3)
    changed = np.concatenate([batch.insert, batch.delete])
    touched = np.unique(changed)
    new_ref = JaxDelta(ref_g, compact_threshold=0).apply_batch(batch).compact()
    new_got = DeltaCSR(got_g, compact_threshold=0).apply_batch(
        EdgeBatch(insert=batch.insert, delete=batch.delete)).compact()
    want = jax_affected(walks, roots, changed, touched, n, mode=mode, old_graph=ref_g,
                        new_graph=new_ref)
    got = affected_roots(torch.from_numpy(walks), roots, changed, touched, n, mode=mode,
                         old_graph=got_g, new_graph=new_got)
    np.testing.assert_array_equal(want, got)
    assert want.sum() > len(touched[touched < n]) * 0.9


def test_corpus_scans_on_hand_made_walks():
    walks = torch.tensor([[0, 1, 2, -1], [2, 3, 4, -1], [4, 3, -1, -1], [-1, -1, -1, -1]],
                         dtype=torch.int32)
    codes = torch.tensor([1 * 5 + 2, 2 * 5 + 1])
    assert incom.paths_traverse_edges(walks, codes, 5).tolist() == [True, False, False, False]
    assert incom.paths_traverse_edges(walks, codes[:0], 5).tolist() == [False] * 4
    mask = torch.tensor([False, False, False, True, False])
    assert incom.paths_visit_nodes(walks, mask).tolist() == [False, True, True, False]
    got = affected_roots(walks, np.array([0, 2, 4, 1]), np.array([[3, 4]]), np.array([3, 4]), 5)
    assert got.tolist() == [False, False, True, True, True]     # 2 -> 3 -> 4, and 4 -> 3


# ---------------------------------------------------------------------------
# (g) the ring splice
# ---------------------------------------------------------------------------

def test_ring_replace_matches_reference():
    import jax.numpy as jnp
    from repro.core.corpus import CorpusRing as JaxRing
    from repro.core.corpus import ring_append as jax_append
    from repro.core.corpus import ring_replace as jax_replace

    rng = np.random.default_rng(4)
    walks = rng.integers(-1, 10, (6, 5)).astype(np.int32)
    walks[:, 0] = np.arange(6)
    lengths = (walks >= 0).sum(1).astype(np.int32)
    new = rng.integers(0, 10, (2, 5)).astype(np.int32)
    new[1, 3:] = -1
    slots, new_len = np.array([4, 1], np.int32), np.array([5, 3], np.int32)
    ref = jax_append(JaxRing.create(8, 5, 10), jnp.asarray(walks), jnp.asarray(lengths))
    ref = jax_replace(ref, jnp.asarray(slots), jnp.asarray(new), jnp.asarray(new_len))
    got = CorpusRing.create(8, 5, 10, "cpu")
    ring_append(got, torch.from_numpy(walks), torch.from_numpy(lengths))
    before = got.walks.clone()
    ring_replace(got, torch.from_numpy(slots), torch.from_numpy(new), torch.from_numpy(new_len))
    np.testing.assert_array_equal(np.asarray(ref.walks), got.walks.numpy())
    np.testing.assert_array_equal(np.asarray(ref.lengths), got.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(ref.ocn), got.ocn.numpy())
    assert (got.cursor, got.total) == (int(ref.cursor), int(ref.total)) == (6, 6)
    kept = [0, 2, 3, 5, 6, 7]
    assert torch.equal(before[kept], got.walks[kept])
    w = got.walks[:6].numpy()
    np.testing.assert_array_equal(np.bincount(w[w >= 0], minlength=10), got.ocn.numpy())


# ---------------------------------------------------------------------------
# (h) the seeded gate
# ---------------------------------------------------------------------------

GATES = [([0.5, 0.41, 0.4, 0.4], 1, 1e-2, [0.4005]),
         ([0.5, 0.41, 0.4, 0.4], 1, 1e-2, [0.46, 0.461, 0.47]),
         ([0.5, 0.4], 2, 1e-3, [0.39, 0.38, 0.3799]),
         ([0.3] * 5, 3, 1e-2, [0.3001, 0.5, 0.2]),
         ([0.6], 3, 1e-3, [0.5, 0.45, 0.449, 0.4489])]


@pytest.mark.parametrize("hist,window,delta,ds", GATES)
def test_seeded_gate_decides_as_the_reference(hist, window, delta, ds):
    from repro.core.termination import WalkCountController as JaxController

    kw = dict(delta=delta, min_rounds=1, max_rounds=len(hist) + 3, window=window,
              seed_history=hist)
    ref, got = JaxController(**kw), WalkCountController(**kw)
    assert got._smooth == ref._smooth and got.history == ref.history
    assert [got.update_d(d) for d in ds] == [ref.update_d(d) for d in ds]
    assert got._smooth == ref._smooth and got.rounds == ref.rounds


# ---------------------------------------------------------------------------
# (i) the refresh from one reference state, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2])
def test_refresh_from_reference_state_matches_reference(small_graph, num_shards):
    import jax
    from repro.core.api import EmbedConfig as JaxConfig
    from repro.core.api import embed_graph as jax_embed
    from repro.core.api import refresh_embedding as jax_refresh
    from repro.graph.generators import churn_batch as jax_churn

    kw = dict(method="deepwalk", info_termination=False, fixed_len=12, fixed_rounds=3, dim=8,
              window=3, negatives=2, seed=4)
    _, _, ref_state = jax_embed(small_graph, JaxConfig(**kw), num_shards=num_shards,
                                return_state=True)
    ref_pipe = ref_state.refresher.pipeline
    tree = jax.tree_util.tree_map(np.asarray, ref_pipe._state_tree())
    state = convert.from_reference_state(tree, device="cpu",
                                         d_history=ref_pipe.controller.history)
    cfg = EmbedConfig(**kw, rng_mode="vertex")
    policy, spec, rounds = make_walk_plan(cfg)
    pipe = StreamingEmbedPipeline(
        state["graph"], policy, spec, rounds,
        DSGLConfig(dim=8, window=3, negatives=2, epochs=1, lr=cfg.lr, multi_windows=2, seed=4),
        assignment=state["assignment"], num_shards=num_shards)
    pipe.adopt_state(state)
    pipe.global_step = ref_pipe.global_step
    assert pipe.controller.history == list(ref_pipe.controller.history)
    assert pipe._rounds_walked == ref_pipe._rounds_walked

    batch = jax_churn(small_graph, 0.05, seed=1)
    _, _, want = jax_refresh(ref_state, batch, fine_tune_steps=60)
    refresher = IncrementalRefresh(pipe)
    refresher.apply_updates(EdgeBatch(insert=batch.insert, delete=batch.delete))
    got = refresher.refresh(fine_tune_steps=60)
    np.testing.assert_array_equal(ref_state.refresher.last_affected_mask,
                                  refresher.last_affected_mask)
    np.testing.assert_array_equal(np.asarray(ref_pipe.ring.walks), pipe.ring.walks.numpy())
    np.testing.assert_array_equal(np.asarray(ref_pipe.ring.lengths), pipe.ring.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(ref_pipe.ring.ocn), pipe.ring.ocn.numpy())
    np.testing.assert_array_equal(ref_pipe._slot_root, pipe._slot_root)
    counts = ("changed_edges", "churn_frac", "affected", "affected_frac", "retained_rounds",
              "extra_rounds", "rewalk_walks", "rewalk_supersteps", "fine_tune_steps", "mode")
    assert {c: getattr(got, c) for c in counts} == {c: getattr(want, c) for c in counts}
    assert got.affected > 0 and got.retained_rounds == 3
    assert pipe.global_step == ref_pipe.global_step
    g2 = ref_state.graph
    assert_same_graph(g2, pipe.graph, "mutated graph")
    auc = lambda phi: link_prediction_auc(port_graph(g2), phi, np.random.default_rng(7))
    assert abs(auc(pipe.embeddings()[0]) - auc(np.asarray(ref_pipe.embeddings()[0]))) < 0.02


# ---------------------------------------------------------------------------
# (k) modes, the detect override, refusals and the API
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_state(small_graph):
    _, _, state = embed_graph(port_graph(small_graph), SMALL_CFG, num_shards=1,
                              return_state=True, device="cpu")
    return state


def test_detect_only_adopts_the_graph_and_leaves_the_ring(small_state, small_graph):
    pipe = small_state.refresher.pipeline
    walks, step = pipe.ring.walks.clone(), pipe.global_step
    _, _, stats = refresh_embedding(small_state, churn_batch(pipe.graph, 0.05, seed=2),
                                    mode="detect_only")
    assert torch.equal(walks, pipe.ring.walks) and pipe.global_step == step
    assert (stats.mode, stats.rewalk_walks, stats.fine_tune_steps) == ("detect_only", 0, 0)
    assert stats.affected == int(small_state.refresher.last_affected_mask.sum()) > 0
    assert pipe.graph.num_edges != small_graph.num_edges       # the mutated graph adopted
    # The debt is paid on the next refresh, under the current graph.
    debt = small_state.refresher.last_affected_mask
    _, _, paid = refresh_embedding(small_state, EdgeBatch(), extra_affected=debt,
                                   fine_tune_steps=2)
    assert paid.affected == int(debt.sum()) and paid.rewalk_walks > 0


def test_no_finetune_rewalks_and_trains_nothing(small_state):
    pipe = small_state.refresher.pipeline
    step, phi = pipe.global_step, pipe.phi_in.clone()
    _, _, stats = refresh_embedding(small_state, churn_batch(pipe.graph, 0.05, seed=2),
                                    mode="no_finetune")
    assert stats.rewalk_walks > 0 and stats.extra_rounds == 0 and stats.fine_tune_steps == 0
    assert pipe.global_step == step and torch.equal(phi, pipe.phi_in)
    with pytest.raises(ValueError, match="unknown refresh mode"):
        refresh_embedding(small_state, EdgeBatch(), mode="eager")


def test_detect_override_is_per_call(small_state):
    assert small_state.refresher.detect == "traversal"
    batch = churn_batch(small_state.graph, 0.02, seed=5)
    _, _, stats = refresh_embedding(small_state, batch, detect="paranoid",
                                    fine_tune_steps=1, max_extra_rounds=0)
    assert small_state.refresher.detect == "traversal" and stats.affected > 0


def test_vertex_growth_is_refused_before_draining(small_state):
    n = small_state.graph.num_nodes
    with pytest.raises(ValueError, match="vertex set"):
        refresh_embedding(small_state, EdgeBatch(insert=np.array([[0, n + 3]])))
    ins, _ = small_state.refresher.delta.pending_changes()
    assert len(ins) == 1                          # nothing was drained


def test_extra_rounds_never_wrap_a_full_ring(small_graph):
    cfg = dataclasses.replace(SMALL_CFG, rng_mode="vertex")
    policy, spec, _ = make_walk_plan(cfg)
    pipe = StreamingEmbedPipeline(port_graph(small_graph).with_edge_cm(), policy, spec,
                                  dict(delta=-1.0, min_rounds=2, max_rounds=2),
                                  DSGLConfig(dim=8, window=3, negatives=2, seed=0))
    pipe.run()
    assert pipe.ring.total == pipe.ring.capacity
    walks_before, roots_before = pipe.ring.walks.clone(), pipe._slot_root.copy()
    refresher = IncrementalRefresh(pipe)
    batch = churn_batch(pipe.graph, 0.05, seed=4)
    stats = refresher.apply_updates(batch).refresh(max_extra_rounds=4)
    assert stats.extra_rounds == 0
    changed = np.concatenate([batch.insert, batch.delete])
    aff = affected_roots(walks_before, roots_before, changed, np.unique(changed),
                         small_graph.num_nodes)
    np.testing.assert_array_equal(aff, refresher.last_affected_mask)
    kept = torch.from_numpy(~aff[roots_before])
    assert torch.equal(walks_before[kept], pipe.ring.walks[kept])
    w = pipe.ring.walks.numpy()
    np.testing.assert_array_equal(np.bincount(w[w >= 0], minlength=small_graph.num_nodes),
                                  pipe.ring.ocn.numpy())


def test_extra_rounds_append_where_the_ring_has_room(small_graph):
    """A run that stopped before the ring filled leaves room: the seeded
    gate appends affected-subset rounds, and their slots map to their roots."""
    _, _, state = embed_graph(port_graph(small_graph), SMALL_CFG, return_state=True,
                              device="cpu")
    pipe = state.refresher.pipeline
    total = pipe.ring.total
    assert total < pipe.ring.capacity
    pipe.controller.delta = -1.0                  # a gate that always walks on
    _, _, stats = refresh_embedding(state, churn_batch(pipe.graph, 0.05, seed=3),
                                    fine_tune_steps=2, max_extra_rounds=2)
    aff = np.nonzero(state.refresher.last_affected_mask)[0]
    assert stats.extra_rounds == 2
    assert pipe._rounds_walked == len(pipe.controller.history) - 1 == total // len(pipe.sources) + 2
    assert pipe.ring.total == total + stats.extra_rounds * len(aff)
    new = np.arange(total, pipe.ring.total)
    np.testing.assert_array_equal(pipe._slot_root[new], np.tile(aff, stats.extra_rounds))
    assert stats.rewalk_walks == stats.extra_rounds * len(aff) + int(
        np.isin(pipe._slot_root[:total], aff).sum())


def test_embed_graph_with_updates_equals_embed_then_refresh(small_graph):
    batch = churn_batch(port_graph(small_graph), 0.05, seed=6)
    a_in, a_out = embed_graph(port_graph(small_graph), SMALL_CFG, updates=batch, device="cpu")
    _, _, state = embed_graph(port_graph(small_graph), SMALL_CFG, return_state=True,
                              device="cpu")
    b_in, b_out, _ = refresh_embedding(state, batch)
    assert torch.equal(a_in, b_in) and torch.equal(a_out, b_out)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_scratch_embed_with_vertex_keys_equals_the_state_embed(small_graph, num_shards):
    """The from-scratch call a refresh is compared with (``rng_mode="vertex"``
    set by the caller) runs the path ``return_state=True`` runs: on the same
    graph it gives the same phi bit for bit."""
    a_in, a_out, _ = embed_graph(port_graph(small_graph), SMALL_CFG, num_shards=num_shards,
                                 return_state=True, device="cpu")
    b_in, b_out = embed_graph(port_graph(small_graph),
                              dataclasses.replace(SMALL_CFG, rng_mode="vertex"),
                              num_shards=num_shards, device="cpu")
    assert torch.equal(a_in, b_in) and torch.equal(a_out, b_out)


def test_state_needs_the_streaming_pipeline_and_a_card(small_graph):
    with pytest.raises(ValueError, match="streaming"):
        embed_graph(port_graph(small_graph), SMALL_CFG, streaming=False, return_state=True,
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            embed_graph(port_graph(small_graph), SMALL_CFG, return_state=True)
    with pytest.raises(ValueError, match="vertex-keyed"):
        policy, spec, rounds = make_walk_plan(SMALL_CFG)       # lane keys
        IncrementalRefresh(StreamingEmbedPipeline(port_graph(small_graph), policy, spec,
                                                  rounds, DSGLConfig(dim=8)))


def test_partitioned_csr_is_never_stale_across_mutation(small_graph):
    g = port_graph(small_graph).with_edge_cm()
    n = g.num_nodes
    asn = np.arange(n) % 2
    d = DeltaCSR(g, compact_threshold=0)
    v1 = d.graph()
    p1 = partitioned_csr_for(v1, asn, 2)
    assert partitioned_csr_for(v1, asn, 2) is p1              # a cache hit
    bump_graph_version(v1)                                    # as a retired view is
    assert partitioned_csr_for(v1, asn, 2) is not p1
    d.apply_batch(EdgeBatch(insert=np.array([[0, n - 1]])))
    p2 = partitioned_csr_for(d.graph(), asn, 2)
    local0 = int(p2.local_of[0])
    row = p2.slices.indices[asn[0]]
    ptr = p2.slices.indptr[asn[0]]
    assert (n - 1) in row[int(ptr[local0]):int(ptr[local0 + 1])].tolist()


def test_walks_see_the_mutation_on_the_local_engine(small_graph):
    g = port_graph(small_graph).with_edge_cm()
    n = g.num_nodes
    spec = WalkSpec(**{**HUGE, "max_len": 16})
    policy, part, src = make_policy("huge"), np.arange(n) % 2, torch.arange(n)
    d = DeltaCSR(g, compact_threshold=0)
    st1 = run_walk_sharded(d.graph(), src, cpu_keys(0, src), policy, spec, part, 2,
                           engine="local")
    hub = int(torch.argmax(g.degrees()))
    nbrs = g.indices[g.indptr[hub]:g.indptr[hub + 1]].numpy()
    d.apply_batch(EdgeBatch(delete=np.stack([np.full(len(nbrs), hub), nbrs], 1)))
    st2 = run_walk_sharded(d.graph(), src, cpu_keys(0, src), policy, spec, part, 2,
                           engine="local")
    assert float(st1.info.L[hub]) > 1.0 and float(st2.info.L[hub]) == 1.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine,k", [("dense", 1), ("replicated", 2), ("local", 4)])
def test_subset_rewalks_equal_full_rows_on_the_card(cuda_device, engine, k):
    from repro_torch.core import mpgp

    graph = rmat_graph(65_536, 10, seed=1, device=cuda_device).with_edge_cm()
    n = graph.num_nodes
    policy, spec = make_policy("huge"), WalkSpec(**{**HUGE, "max_len": 100, "min_len": 20})
    part = mpgp.mpgp_partition(graph, k).assignment if k > 1 else None
    walk = lambda src: (run_walk_batch(graph, src, VertexKeys(prng.PRNGKey(4), src), policy,
                                       spec) if engine == "dense" else
                        run_walk_sharded(graph, src, VertexKeys(prng.PRNGKey(4), src), policy,
                                         spec, part, k, engine=engine))
    full = walk(torch.arange(n, device=cuda_device))
    ids = torch.from_numpy(np.random.default_rng(0).choice(n, 5_000, replace=False)
                           ).to(cuda_device)
    sub = walk(ids)
    assert torch.equal(sub.path, full.path[ids]) and torch.equal(sub.info.L, full.info.L[ids])


@pytest.mark.cuda
def test_refresh_keeps_unaffected_slots_and_cm_on_the_card(cuda_device):
    graph = rmat_graph(65_536, 10, seed=1, device=cuda_device)
    cfg = EmbedConfig(dim=32, epochs=1, lr=0.05, delta=1e-3, max_len=40, min_len=10, window=6,
                      negatives=4)
    phi0, _, state = embed_graph(graph, cfg, num_shards=2, return_state=True,
                                 device=cuda_device)
    scratch, _ = embed_graph(graph, dataclasses.replace(cfg, rng_mode="vertex"), num_shards=2,
                             device=cuda_device)
    assert torch.equal(scratch, phi0)          # the scratch call runs the state's path
    pipe = state.refresher.pipeline
    walks_before, roots_before = pipe.ring.walks.clone(), pipe._slot_root.copy()
    phi1, _, stats = refresh_embedding(state, churn_batch(graph, 0.05, seed=1))
    aff = state.refresher.last_affected_mask
    written = roots_before >= 0
    kept = torch.from_numpy(np.nonzero(written & ~aff[np.maximum(roots_before, 0)])[0]
                            ).to(cuda_device)
    assert len(kept) > 0 and torch.equal(walks_before[kept], pipe.ring.walks[kept])
    assert stats.affected_frac <= 0.30 and torch.isfinite(phi1).all()
    g2 = state.graph
    assert g2.device.type == "cuda" and torch.equal(g2.edge_cm, edge_common_neighbors(g2))
