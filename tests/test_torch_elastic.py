"""Elastic walk shards on the port: a shard's loss and its re-join.

The partition layer against the JAX package's, bit for bit: MPGP's
``reassign_dead_shard``, ``compact_assignment`` and ``rejoin_shard`` (on
rmat 128 at k = 4, the reference test's ``part4``, and on graphs of 2,048
and 4,096 nodes, where the re-join's breadth-first donor search runs over
several levels and stops a shard at its surplus), and the partial
``reassign_partitioned_csr`` against a fresh ``build_partitioned_csr`` and
the reference's rebuild, for every dead shard and for a re-join.
``reconfigure_partitions`` evicts the replaced layout's cache entries and
primes the new one.

The pipeline, ported from ``tests/test_selfheal.py`` and
``tests/test_recovery.py``: the liveness probe's threshold and
hysteresis, a shard's death mid-run, a double death, a transient outage
with its re-join, a direct reconfigure and re-join, a resume after each,
``recover_shard_loss`` and the refusals. Each is held to the port's own
fault-free k = 4 run, bit for bit (vertex keys: a walk depends on neither
the shard count nor the assignment). One fixed-mode elastic run is held to
the reference's: the same ring bit for bit, AUCs within 0.02.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mpgp, shard_engine
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.graph.csr import build_partitioned_csr, reassign_partitioned_csr
from repro_torch.graph.generators import rmat_graph
from repro_torch.runtime.faults import FaultInjector, LivenessProbe
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: Fixed-mode DeepWalk with short walks: six rounds, so six liveness polls.
PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=6, dim=16,
            seed=3, rng_mode="vertex")
DSGL = dict(dim=16, seed=3)

#: (|V|, degree, seed, k) of the partition-layer cases.
GRAPHS = {"rmat128": (128, 7, 7, 4), "rmat2048": (2048, 10, 3, 4)}
_CACHE = {}


def _plan(plan=PLAN, dsgl=DSGL):
    return (*make_walk_plan(EmbedConfig(**plan)), DSGLConfig(**dsgl))


def _pipeline(graph, **kw):
    return StreamingEmbedPipeline(graph, *_plan(), **kw)


def _graphs(name):
    """(reference graph, port graph with Cm, the port's MPGP k-way partition
    with degree tau, k), built once."""
    if name not in _CACHE:
        from repro.graph.generators import rmat_graph as ref_rmat

        n, d, seed, k = GRAPHS[name]
        g = rmat_graph(n, d, seed=seed, device="cpu").with_edge_cm()
        part = mpgp.mpgp_partition(g, k, tau_weight="degree").assignment
        _CACHE[name] = (ref_rmat(n, d, seed=seed), g, part, k)
    return _CACHE[name]


@pytest.fixture(scope="module")
def graph():
    return _graphs("rmat128")[1]


@pytest.fixture(scope="module")
def part4():
    return _graphs("rmat128")[2]


@pytest.fixture(scope="module")
def reference4(graph, part4):
    """The port's fault-free k = 4 run: the bit-identity target."""
    p = _pipeline(graph, assignment=part4, num_shards=4)
    p.run()
    return p


def _same_run(want, got) -> bool:
    return (torch.equal(want.ring.walks, got.ring.walks)
            and torch.equal(want.ring.ocn, got.ring.ocn)
            and torch.equal(want.phi_in, got.phi_in) and torch.equal(want.phi_out, got.phi_out))


# --- the partition: MPGP against the reference ---------------------------------


def test_part4_is_the_references(part4):
    from repro.core.mpgp import mpgp_partition as ref_partition

    ref_g = _graphs("rmat128")[0]
    np.testing.assert_array_equal(part4, ref_partition(ref_g, 4, tau_weight="degree").assignment)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_reassign_compact_rejoin_match_the_reference(name):
    """Every dead shard: the orphans' stream, the compaction and the re-join
    from the compacted layout, bit for bit."""
    from repro.core import mpgp as ref_mpgp

    ref_g, g, part, k = _graphs(name)
    for dead in range(k):
        got = mpgp.reassign_dead_shard(g, part, dead, num_parts=k)
        want = ref_mpgp.reassign_dead_shard(ref_g, part, dead, num_parts=k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32
        comp, old_of_new = mpgp.compact_assignment(got, dead, num_parts=k)
        ref_comp, ref_old = ref_mpgp.compact_assignment(want, dead, num_parts=k)
        np.testing.assert_array_equal(comp, ref_comp)
        np.testing.assert_array_equal(old_of_new, ref_old)
        grown, moved = mpgp.rejoin_shard(g, comp, num_parts=k - 1)
        ref_grown, ref_moved = ref_mpgp.rejoin_shard(ref_g, ref_comp, num_parts=k - 1)
        np.testing.assert_array_equal(grown, ref_grown)
        np.testing.assert_array_equal(moved, ref_moved)


@pytest.mark.parametrize("n,degree,seed,k,tau", [(2048, 10, 3, 4, "degree"),
                                                 (2048, 10, 3, 4, "nodes"),
                                                 (4096, 4, 5, 2, "nodes")])
def test_rejoin_donor_search_matches_the_reference(n, degree, seed, k, tau, monkeypatch):
    """The level-at-a-time donor search against the reference's deque, on
    searches of hundreds of donors over several levels; the last case
    spends shard 0's surplus within a level (the per-shard stop)."""
    from repro.core import mpgp as ref_mpgp
    from repro.graph.generators import rmat_graph as ref_rmat

    ref_g = ref_rmat(n, degree, seed=seed)
    g = rmat_graph(n, degree, seed=seed, device="cpu")
    part = ref_mpgp.mpgp_partition(ref_g, k, tau_weight="degree").assignment
    spent = []
    search = mpgp._bfs_donors

    def spy(g, asn, load_of, surplus, seed, target):
        donors = search(g, asn, load_of, surplus, seed, target)
        spent.append((len(donors), bool((surplus <= 0).any())))
        return donors

    monkeypatch.setattr(mpgp, "_bfs_donors", spy)
    grown, moved = mpgp.rejoin_shard(g, part, num_parts=k, tau_weight=tau)
    want, want_moved = ref_mpgp.rejoin_shard(ref_g, part, num_parts=k, tau_weight=tau)
    np.testing.assert_array_equal(grown, want)
    np.testing.assert_array_equal(moved, want_moved)
    assert spent[0][0] >= 50 and moved.sum() == spent[0][0]
    if n == 4096:
        assert spent[0][1]                  # a shard's surplus ran out mid-search


def test_reassign_dead_shard_empties_it(graph, part4):
    new = mpgp.reassign_dead_shard(graph, part4, 1, num_parts=4)
    assert (new != 1).all()
    np.testing.assert_array_equal(new[part4 != 1], part4[part4 != 1])


def test_compact_assignment(graph, part4):
    new = mpgp.reassign_dead_shard(graph, part4, 1, num_parts=4)
    comp, old_of_new = mpgp.compact_assignment(new, 1, num_parts=4)
    assert comp.min() >= 0 and comp.max() <= 2
    np.testing.assert_array_equal(old_of_new, [0, 2, 3])
    for new_id, old_id in enumerate(old_of_new):
        np.testing.assert_array_equal(comp == new_id, new == old_id)
    with pytest.raises(ValueError, match="dead shard 1"):
        mpgp.compact_assignment(part4, 1, num_parts=4)


def test_rejoin_appends_a_nonempty_shard(graph, part4):
    asn3, _ = mpgp.compact_assignment(mpgp.reassign_dead_shard(graph, part4, 3, num_parts=4),
                                      3, num_parts=4)
    asn4, moved = mpgp.rejoin_shard(graph, asn3, num_parts=3)
    assert asn4.max() == 3 and (asn4 == 3).sum() > 0 and moved.any()
    np.testing.assert_array_equal(asn4[~moved], asn3[~moved])
    assert (asn4[moved] == 3).all()


def test_partition_refusals(graph, part4):
    with pytest.raises(ValueError, match="out of range"):
        mpgp.reassign_dead_shard(graph, part4, 4, num_parts=4)
    with pytest.raises(ValueError, match="only shard"):
        mpgp.reassign_dead_shard(graph, np.zeros_like(part4), 0, num_parts=1)
    with pytest.raises(ValueError, match="dense"):
        mpgp.rejoin_shard(graph, part4, num_parts=3)


# --- the partition-local store ---------------------------------------------------


def _same_store(got, want, ref=None):
    for f in ("indptr", "indices", "nbr_owner", "nbr_deg", "weights", "edge_cm"):
        a, b = getattr(got.slices, f), getattr(want.slices, f)
        if a is None:
            assert b is None and (ref is None or getattr(ref.slices, f) is None), f
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), f
        if ref is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref.slices, f)), f)
    assert torch.equal(got.local_of, want.local_of) and got.local_of.dtype == want.local_of.dtype
    np.testing.assert_array_equal(got.owned, want.owned)
    np.testing.assert_array_equal(got.num_owned, want.num_owned)
    assert got.num_parts == want.num_parts
    if ref is not None:
        np.testing.assert_array_equal(got.local_of.numpy(), np.asarray(ref.local_of))
        np.testing.assert_array_equal(got.owned, ref.owned)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("dead", [0, 1, 3])
def test_partial_rebuild_matches_a_fresh_build(name, dead):
    """A death (k -> k-1, compacted) and the re-join after it (k-1 -> k,
    -1 in old_of_new): the rebuilt store equals a fresh build field for
    field, and the reference's rebuild value for value, with as many
    shards reused."""
    from repro.graph.csr import build_partitioned_csr as ref_build
    from repro.graph.csr import reassign_partitioned_csr as ref_reassign

    ref_g, g, part, k = _graphs(name)
    ref_g = ref_g.with_edge_cm()            # the port's store carries Cm too
    comp, old_of_new = mpgp.compact_assignment(
        mpgp.reassign_dead_shard(g, part, dead, num_parts=k), dead, num_parts=k)
    got, reused = reassign_partitioned_csr(g, comp, k - 1, old=build_partitioned_csr(g, part, k),
                                           old_assignment=part, old_of_new=old_of_new)
    want, ref_reused = ref_reassign(ref_g, comp, k - 1, old=ref_build(ref_g, part, k),
                                    old_assignment=part, old_of_new=old_of_new)
    _same_store(got, build_partitioned_csr(g, comp, k - 1), want)
    assert reused == ref_reused and 0 <= reused <= k - 1

    grown, _ = mpgp.rejoin_shard(g, comp, num_parts=k - 1)
    split = np.r_[np.arange(k - 1), -1]
    got, reused = reassign_partitioned_csr(g, grown, k, old=build_partitioned_csr(g, comp, k - 1),
                                           old_assignment=comp, old_of_new=split)
    want, ref_reused = ref_reassign(ref_g, grown, k, old=ref_build(ref_g, comp, k - 1),
                                    old_assignment=comp, old_of_new=split)
    _same_store(got, build_partitioned_csr(g, grown, k), want)
    assert reused == ref_reused and reused <= k - 1     # the donor and the new shard rebuild


def test_partial_rebuild_on_a_weighted_graph():
    g = rmat_graph(600, 6, seed=4, weighted=True, device="cpu").with_edge_cm()
    part = mpgp.mpgp_partition(g, 3, tau_weight="degree").assignment
    for dead in range(3):
        comp, old_of_new = mpgp.compact_assignment(
            mpgp.reassign_dead_shard(g, part, dead, num_parts=3), dead, num_parts=3)
        got, _ = reassign_partitioned_csr(g, comp, 2, old=build_partitioned_csr(g, part, 3),
                                          old_assignment=part, old_of_new=old_of_new)
        _same_store(got, build_partitioned_csr(g, comp, 2))
        assert got.slices.weights is not None


def _keys_of(h):
    return ([k for k in shard_engine._PCSR_CACHE if k[4] == h],
            [k for k in shard_engine._POOL_CACHE if k[-1] == h])


def test_reconfigure_partitions_evicts_and_primes(graph, part4):
    """The replaced layout's slices and pool sizes leave the cache; the new
    layout's store is primed, so the next lookup hits it; a re-join reuses
    the death's primed store."""
    from repro_torch.graph.delta import graph_version

    shard_engine._PCSR_CACHE.clear()
    shard_engine._POOL_CACHE.clear()
    old = shard_engine.partitioned_csr_for(graph, part4, 4)
    h_old = hash(np.asarray(part4).tobytes())
    pool_key = (id(graph), graph_version(graph), 4, 128, "spec", 2.0, h_old)
    import weakref
    shard_engine._POOL_CACHE[pool_key] = (weakref.ref(graph), 64)
    comp, old_of_new = mpgp.compact_assignment(
        mpgp.reassign_dead_shard(graph, part4, 2, num_parts=4), 2, num_parts=4)
    out = shard_engine.reconfigure_partitions(graph, part4, comp, 3, old_of_new=old_of_new)
    assert out["reused_shards"] + out["rebuilt_shards"] == 3 and out["reused_shards"] >= 1
    assert out["wall_s"] > 0
    assert _keys_of(h_old) == ([], [])
    primed = shard_engine.partitioned_csr_for(graph, comp, 3)
    assert primed is not old
    _same_store(primed, build_partitioned_csr(graph, comp, 3))
    assert len(shard_engine._PCSR_CACHE) == 1

    grown, _ = mpgp.rejoin_shard(graph, comp, num_parts=3)
    out = shard_engine.reconfigure_partitions(graph, comp, grown, 4,
                                              old_of_new=np.r_[np.arange(3), -1],
                                              num_shards_old=3)
    assert out["reused_shards"] >= 1 and out["rebuilt_shards"] >= 2
    assert _keys_of(hash(comp.tobytes())) == ([], [])
    _same_store(shard_engine.partitioned_csr_for(graph, grown, 4),
                build_partitioned_csr(graph, grown, 4))

    # Nothing cached for the old layout: a fresh build, nothing reused.
    shard_engine._PCSR_CACHE.clear()
    out = shard_engine.reconfigure_partitions(graph, part4, comp, 3, old_of_new=old_of_new)
    assert out["reused_shards"] == 0 and out["rebuilt_shards"] == 3
    shard_engine._PCSR_CACHE.clear()


def test_primed_store_walks_as_the_dense_engine(graph, part4):
    """The local engine on the primed k-1 store draws the dense engine's
    walks."""
    from repro_torch import prng
    from repro_torch.core.walker import VertexKeys, run_walk_batch

    shard_engine._PCSR_CACHE.clear()
    policy, spec, _, _ = _plan()
    comp, old_of_new = mpgp.compact_assignment(
        mpgp.reassign_dead_shard(graph, part4, 0, num_parts=4), 0, num_parts=4)
    shard_engine.partitioned_csr_for(graph, part4, 4)
    shard_engine.reconfigure_partitions(graph, part4, comp, 3, old_of_new=old_of_new)
    src = torch.arange(graph.num_nodes)
    keys = VertexKeys(prng.fold_in(prng.PRNGKey(3), 0), src)
    dense = run_walk_batch(graph, src, keys, policy, spec)
    local = shard_engine.run_walk_sharded(graph, src, keys, policy, spec, comp, 3, engine="local")
    assert torch.equal(dense.path, local.path)
    shard_engine._PCSR_CACHE.clear()


# --- the liveness probe --------------------------------------------------------


def test_liveness_probe_threshold():
    live = LivenessProbe(num_shards=4, misses_to_dead=2)
    faults = FaultInjector(down_plan={2: 0})
    assert live.poll(faults) == []          # one miss: below the threshold
    assert live.poll(faults) == [2]
    assert live.remove(2) == 2
    assert live.names == [0, 1, 3] and live.dead_names == [2]
    assert live.poll(faults) == []
    live2 = LivenessProbe(num_shards=4, misses_to_dead=1)   # ids compact with the assignment
    live2.remove(1)
    assert live2.poll(FaultInjector(down_plan={3: 0})) == [2]
    assert live2.remove(2) == 3


def test_liveness_rejoin_hysteresis():
    live = LivenessProbe(num_shards=3, misses_to_dead=1, hits_to_live=2)
    down = FaultInjector(down_plan={2: 0})
    assert live.poll(down) == [2] and live.remove(2) == 2
    live.poll(down)
    assert live.rejoinable() == []
    flap = FaultInjector(down_plan={2: (0, 1)})
    live2 = LivenessProbe(num_shards=3, misses_to_dead=1, hits_to_live=2)
    assert live2.poll(flap) == [2]
    live2.remove(2)
    live2.poll(flap)
    assert live2.rejoinable() == []
    live2.poll(flap)
    assert live2.rejoinable() == [2] and live2.rejoin(2) == 2
    assert live2.names == [0, 1, 2] and live2.dead_names == []


# --- the pipeline ------------------------------------------------------------------


def test_shard_death_mid_run_is_bit_identical(graph, part4, reference4, tmp_path):
    p = _pipeline(graph, assignment=part4, num_shards=4)
    res = p.run(ckpt_root=str(tmp_path / "death"), ckpt_every_rounds=2,
                faults=FaultInjector(down_plan={2: 2}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=2))
    assert p.walk_shards == 3 and len(res["reconfigs"]) == 1
    rec = res["reconfigs"][0]
    assert rec["dead_shard"] == 2 and rec["walk_shards"] == 3 and rec["launch_id"] == 2
    assert rec["wall_s"] > 0 and rec["moved_roots"] == int((part4 == 2).sum())
    assert rec["rewalk_walks"] > 0 and rec["reused_shards"] + rec["rebuilt_shards"] == 3
    assert p.num_shards == 4 and p.phi_in.shape[0] == 4      # the replicas stay
    assert _same_run(reference4, p)


def test_double_shard_death(graph, part4, reference4, tmp_path):
    p = _pipeline(graph, assignment=part4, num_shards=4)
    res = p.run(ckpt_root=str(tmp_path / "double"), ckpt_every_rounds=2,
                faults=FaultInjector(down_plan={1: 2, 3: 4}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=2))
    assert p.walk_shards == 2 and len(res["reconfigs"]) == 2
    assert [r["launch_id"] for r in res["reconfigs"]] == [1, 3]
    assert _same_run(reference4, p)


def test_transient_outage_rejoin_is_bit_identical(graph, part4, reference4, tmp_path):
    p = _pipeline(graph, assignment=part4, num_shards=4)
    res = p.run(ckpt_root=str(tmp_path / "rejoin"), ckpt_every_rounds=2,
                faults=FaultInjector(down_plan={2: (1, 3)}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=1, hits_to_live=1))
    kinds = [r.get("kind", "death") for r in res["reconfigs"]]
    assert kinds == ["death", "rejoin"] and p.walk_shards == 4
    rejoin = res["reconfigs"][1]
    assert rejoin["walk_shards"] == 4 and rejoin["moved_roots"] > 0
    assert rejoin["launch_id"] == 2 and int(p.assignment.max()) == 3
    assert _same_run(reference4, p)


def test_reconfigure_changes_the_next_walk_only(graph, part4, monkeypatch):
    """A death found at round r's poll (rounds 0..r walked) dispatches round
    r+1 at k-1; the orphans' resident walks are walked again at k-1 too."""
    from repro_torch.runtime import trainer

    dispatched = []
    walk = trainer.run_walk_batch

    def spy(*args, num_shards=None, **kw):
        dispatched.append(num_shards)
        return walk(*args, num_shards=num_shards, **kw)

    monkeypatch.setattr(trainer, "run_walk_batch", spy)
    p = _pipeline(graph, assignment=part4, num_shards=4)
    res = p.run(faults=FaultInjector(down_plan={2: 2}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=2))
    # Dead at poll 3: rounds 0-3 walked at k = 4, their orphans again at 3,
    # then rounds 4 and 5 at 3.
    assert res["reconfigs"][0]["rounds_resident"] == 4
    assert dispatched == [4] * 4 + [3] * 4 + [3] * 2


def test_direct_reconfigure_then_rejoin_then_run(graph, part4, reference4):
    p = _pipeline(graph, assignment=part4, num_shards=4)
    p.elastic_reconfigure(2)
    assert p.walk_shards == 3
    stats = p.elastic_rejoin()
    assert stats["kind"] == "rejoin" and p.walk_shards == 4
    assert stats["reused_shards"] + stats["rebuilt_shards"] == 4
    p.run()
    assert [r.get("kind", "death") for r in p._reconfigs] == ["death", "rejoin"]
    assert _same_run(reference4, p)


@pytest.mark.parametrize("plan,k", [({2: 2}, 3), ({2: (1, 3)}, 4)])
def test_resume_keeps_the_elastic_layout(graph, part4, tmp_path, plan, k):
    """The snapshot after a reconfiguration (or a re-join) resumes at its k
    and assignment: a rollback never brings back the outage's layout."""
    from repro_torch.ckpt.checkpoint import read_meta

    p = _pipeline(graph, assignment=part4, num_shards=4)
    root = str(tmp_path / "resume")
    live = LivenessProbe(num_shards=4, misses_to_dead=2 if k == 3 else 1, hits_to_live=1)
    p.run(ckpt_root=root, ckpt_every_rounds=1, faults=FaultInjector(down_plan=plan),
          liveness=live)
    assert p.walk_shards == k and read_meta(root)[1]["walk_shards"] == k
    q = StreamingEmbedPipeline.resume(root, *_plan()[:2], _plan()[3], device="cpu")
    assert q.walk_shards == k
    np.testing.assert_array_equal(q.assignment, p.assignment)
    assert torch.equal(q.phi_in, p.phi_in) and torch.equal(q.ring.walks, p.ring.walks)


def test_recover_shard_loss_restores_the_ring(graph):
    """Zap every slot rooted in shard 1 (``ring_replace`` keeps ocn true to
    the damaged ring), then walk the shard's resident walks again: ring
    and ocn exactly as before."""
    from repro_torch.core.corpus import ring_replace

    part = mpgp.mpgp_partition(graph, 2).assignment
    p = _pipeline(graph, assignment=part, num_shards=2)
    p.run()
    walks, ocn, phi = p.ring.walks.clone(), p.ring.ocn.clone(), p.phi_in.clone()
    lost = part == 1
    bad = np.nonzero((p._slot_root >= 0) & lost[np.maximum(p._slot_root, 0)])[0]
    assert len(bad) > 0
    ring_replace(p.ring, torch.from_numpy(bad), torch.zeros(len(bad), p.ring.walks.shape[1],
                                                            dtype=p.ring.walks.dtype),
                 torch.ones(len(bad), dtype=torch.int32))
    assert not torch.equal(p.ring.walks, walks)
    info = p.recover_shard_loss(1)
    assert info["lost_roots"] == int(lost.sum()) and info["rewalk_walks"] >= len(bad)
    assert info["rounds_resident"] == 6
    assert torch.equal(p.ring.walks, walks) and torch.equal(p.ring.ocn, ocn)
    assert torch.equal(p.phi_in, phi)


def test_refusals(graph, part4):
    lane = dict(PLAN, rng_mode="lane")
    p = StreamingEmbedPipeline(graph, *_plan(lane), assignment=part4, num_shards=4)
    with pytest.raises(ValueError, match="vertex"):
        p.recover_shard_loss(0)
    with pytest.raises(ValueError, match="vertex"):
        p.elastic_reconfigure(0)
    with pytest.raises(ValueError, match="vertex"):
        p.elastic_rejoin()
    q = _pipeline(graph)
    with pytest.raises(ValueError, match="shard"):
        q.recover_shard_loss(3)
    with pytest.raises(ValueError, match="assignment"):
        q.elastic_reconfigure(0)
    r = _pipeline(graph, assignment=part4, num_shards=4)
    with pytest.raises(ValueError, match="not in"):
        r.elastic_reconfigure(4)
    s = _pipeline(graph, assignment=np.zeros_like(part4), num_shards=1)
    with pytest.raises(ValueError, match="last walk shard"):
        s.elastic_reconfigure(0)


# --- against the reference ------------------------------------------------------------


def test_fixed_mode_elastic_run_matches_the_reference(tmp_path):
    """The transient outage on rmat 256 in both packages, fixed-mode walks
    and a few hundred training steps: the port's elastic ring is the
    reference's bit for bit, the AUCs within 0.02, the telemetry
    (``pipeline.reconfigs``, ``pipeline.rejoins``, ``walk.shards`` and the
    run's others) the same names and values; the reference's state
    converts with its walk shard count."""
    import jax

    from benchmarks.common import link_prediction_auc as ref_auc
    from repro.core.api import EmbedConfig as RefEmbedConfig
    from repro.core.api import make_walk_plan as ref_plan
    from repro.core.dsgl import DSGLConfig as RefDSGLConfig
    from repro.core.mpgp import mpgp_partition as ref_partition
    from repro.graph.generators import rmat_graph as ref_rmat
    from repro.runtime.faults import FaultInjector as RefFaults
    from repro.runtime.faults import LivenessProbe as RefProbe
    from repro.runtime.trainer import StreamingEmbedPipeline as RefPipeline
    from repro_torch.convert import from_reference_state
    from repro_torch.eval import link_prediction_auc

    from repro import obs as ref_obs
    from repro_torch import obs

    dsgl = dict(dim=16, seed=3, batch_groups=16, epochs=4, lr=0.05)
    ref_g, g = ref_rmat(256, 8, seed=7), rmat_graph(256, 8, seed=7, device="cpu")
    part = ref_partition(ref_g, 4, tau_weight="degree").assignment
    for o in (ref_obs, obs):
        o.reset()
        o.configure(enabled=True, clear_sinks=True)
    ref = RefPipeline(ref_g, *ref_plan(RefEmbedConfig(**PLAN)), RefDSGLConfig(**dsgl),
                      assignment=part, num_shards=4)
    ref_res = ref.run(ckpt_root=str(tmp_path / "ref"), ckpt_every_rounds=2,
                      faults=RefFaults(down_plan={2: (1, 3)}),
                      liveness=RefProbe(num_shards=4, misses_to_dead=1, hits_to_live=1))
    p = StreamingEmbedPipeline(g, *_plan(dsgl=dsgl), assignment=part, num_shards=4)
    res = p.run(ckpt_root=str(tmp_path / "port"), ckpt_every_rounds=2,
                faults=FaultInjector(down_plan={2: (1, 3)}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=1, hits_to_live=1))
    got_tele, ref_tele = obs.REGISTRY.snapshot(), ref_obs.REGISTRY.snapshot()
    for o in (ref_obs, obs):
        o.reset()
    assert sorted(got_tele["histograms"]) == sorted(ref_tele["histograms"])
    for name, want in ref_tele["histograms"].items():       # times: the counts compare
        assert got_tele["histograms"][name]["count"] == want["count"], name
    assert got_tele["counters"] == ref_tele["counters"]
    assert got_tele["gauges"] == ref_tele["gauges"]
    assert got_tele["counters"]["pipeline.reconfigs"] == got_tele["counters"]["pipeline.rejoins"] == 1
    assert got_tele["gauges"]["walk.shards"] == 4
    assert [(r.get("kind"), r["walk_shards"], r["moved_roots"], r["launch_id"])
            for r in res["reconfigs"]] == \
        [(r.get("kind"), r["walk_shards"], r["moved_roots"], r["launch_id"])
         for r in ref_res["reconfigs"]]
    np.testing.assert_array_equal(p.ring.walks.numpy(), np.asarray(ref.ring.walks))
    np.testing.assert_array_equal(p.assignment, np.asarray(ref.assignment))
    ref_in = np.asarray(ref.embeddings()[0])
    auc_ref = ref_auc(ref_g, ref_in, np.random.default_rng(7))
    auc = link_prediction_auc(g, p.embeddings()[0], np.random.default_rng(7))
    print(f"elastic AUC: port {auc:.6f}, reference {auc_ref:.6f}")
    assert abs(auc - auc_ref) <= 0.02, (auc, auc_ref)

    state = from_reference_state(jax.tree_util.tree_map(np.asarray, ref._state_tree()), "cpu",
                                 walk_shards=ref.walk_shards)
    q = StreamingEmbedPipeline(g, *_plan(dsgl=dsgl), num_shards=4)
    q.adopt_state(state)
    assert q.walk_shards == 4 and torch.equal(q.ring.walks, p.ring.walks)
    np.testing.assert_array_equal(q.assignment, p.assignment)
