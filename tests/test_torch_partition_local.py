"""The port's partition-local walk engine: slot pools over the partition's
CSR slices, the packed exchange under its three transports, ghost slots,
spill rounds and pool growth, against the JAX reference (fixed-mode walks,
bit for bit, with the per-shard stats) and against the port's dense engine
(HuGE + InCoM, bit for bit). The reference's local engine compiles once per
(k, pool, cap, transport, compact_every), slowly on the CPU, so its runs
use few of them and are shared through a module fixture. The reference is
imported inside the fixture and tests that use it.
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import incom, mpgp
from repro_torch.core import shard_engine
from repro_torch.core.shard_engine import partitioned_csr_for, run_walk_sharded
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import LaneKeys, WalkSpec, run_walk_batch
from repro_torch.graph.csr import build_csr
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

INFO = ("H", "L", "EH", "EL", "EHL", "EH2", "EL2")
FIXED = dict(max_len=24, info_mode="fixed", fixed_len=24)
HUGE = dict(max_len=40, min_len=8, mu=0.995, info_mode="incom", reg_start=16)
LANES = 128
# (k, engine kwargs) of the reference runs. The reference unrolls a block
# of ``compact_every`` supersteps into its compiled program, so most runs
# flush every superstep: every k at a pool of B (no retry) but k = 4 at the
# default pool factor (one retry); the three transports at k = 4 (gather
# with cap 16 in a block of two supersteps, a2a with cap 8).
REF_RUNS = [(1, dict(pool_factor=1.0, compact_every=1)),
            (2, dict(pool_factor=2.0, compact_every=1)),
            (4, dict(compact_every=1)),
            (8, dict(pool_factor=8.0, compact_every=1)),
            (4, dict(pool_factor=4.0, compact_every=1, transport="pool")),
            (4, dict(pool_factor=4.0, compact_every=1, transport="a2a", exchange_cap=8)),
            (4, dict(pool_factor=4.0, compact_every=2, transport="gather", exchange_cap=16))]


@pytest.fixture(scope="module")
def medium():
    return rmat_graph(1024, 10, seed=3, device="cpu").with_edge_cm()


@pytest.fixture(scope="module")
def plain():
    """The graph without Cm, as DeepWalk's walks slice it."""
    return rmat_graph(1024, 10, seed=3, device="cpu")


@pytest.fixture(scope="module")
def parts(medium):
    p4 = mpgp.mpgp_partition(medium, 4, gamma=2.0).assignment.astype(np.int64)
    n = medium.num_nodes
    return {1: np.zeros(n, np.int64), 2: p4 % 2, 4: p4, 8: np.arange(n) % 8}


def keys_of(seed, lanes=LANES):
    return LaneKeys.of([prng.PRNGKey(seed)], lanes, lanes, "cpu")


def hops(paths: np.ndarray, part: np.ndarray) -> int:
    a, b = paths[:, :-1], paths[:, 1:]
    ok = (a >= 0) & (b >= 0)
    return int((ok & (part[np.maximum(a, 0)] != part[np.maximum(b, 0)])).sum())


def local(graph, part, k, spec=WalkSpec(**HUGE), seed=11, lanes=LANES, policy="huge", **kw):
    return run_walk_sharded(graph, torch.arange(lanes) % graph.num_nodes, keys_of(seed, lanes),
                            make_policy(policy), spec, part, k, engine="local", **kw)


@pytest.fixture(scope="module")
def dense(medium):
    """The dense engine's HuGE + InCoM walks, which every engine must draw."""
    return run_walk_batch(medium, torch.arange(LANES), keys_of(11), make_policy("huge"),
                          WalkSpec(**HUGE))


def assert_same_walks(got, want, what=""):
    np.testing.assert_array_equal(got.path.numpy(), want.path.numpy(), err_msg=what)
    for f in INFO:
        np.testing.assert_array_equal(getattr(got.info, f).numpy(),
                                      getattr(want.info, f).numpy(), err_msg=f"{what} {f}")
    assert (got.supersteps, int(got.accepts), int(got.rejects)) == \
        (want.supersteps, int(want.accepts), int(want.rejects)), what


@pytest.fixture(scope="module")
def reference_runs(medium_graph, parts):
    """The reference's local engine on DeepWalk fixed-mode walks: one run
    per REF_RUNS entry, with its stats."""
    import jax
    import jax.numpy as jnp
    from repro.core import shard_engine as jax_shard_engine
    from repro.core.shard_engine import run_walk_sharded as jax_run
    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec

    jax_shard_engine._POOL_CACHE.clear()       # each run finds its own pool size
    return [jax_run(medium_graph, jnp.arange(LANES, dtype=jnp.int32), jax.random.PRNGKey(5),
                    jax_make_policy("deepwalk"), JaxWalkSpec(**FIXED),
                    jnp.asarray(parts[k], jnp.int32), k, engine="local", with_stats=True, **kw)
            for k, kw in REF_RUNS]


@pytest.mark.parametrize("run", range(len(REF_RUNS)))
def test_local_engine_matches_reference(plain, parts, reference_runs, run, monkeypatch):
    """Fixed-mode walks and their measured traffic, bit for bit, at every k
    and under every transport, and the per-shard stats (supersteps,
    hand-offs, lane occupancy, pool size and retries, owned nodes, CSR
    bytes)."""
    monkeypatch.setattr(shard_engine, "_POOL_CACHE", {})
    k, kw = REF_RUNS[run]
    ref, ref_stats = reference_runs[run]
    got, stats = run_walk_sharded(plain, torch.arange(LANES), keys_of(5),
                                  make_policy("deepwalk"), WalkSpec(**FIXED), parts[k], k,
                                  engine="local", with_stats=True, **kw)
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.info.L.numpy(), np.asarray(ref.info.L))
    assert (got.supersteps, int(got.accepts), int(got.rejects)) == \
        (int(ref.supersteps), int(ref.accepts), int(ref.rejects))
    assert int(got.msg_count) == int(ref.msg_count) == hops(got.path.numpy(), parts[k])
    assert float(got.msg_bytes) == float(ref.msg_bytes) == float(got.msg_bytes_analytic)
    assert float(got.msg_bytes_analytic) == float(ref.msg_bytes_analytic)
    assert (int(got.msg_count) > 0) == (k > 1)
    shared = {name: v for name, v in stats.items() if name in ref_stats}
    assert shared == ref_stats
    assert stats["host_reads"] > 0 and stats["exchange_rounds"] >= got.supersteps


@pytest.mark.parametrize("k,transport,cap", [(1, None, None), (2, None, None), (4, None, None),
                                             (8, None, None), (4, "pool", None),
                                             (4, "a2a", 8), (4, "gather", 16)])
def test_local_huge_walks_equal_dense_engine(medium, parts, dense, k, transport, cap):
    """HuGE + InCoM: paths and all seven moments equal the dense engine's,
    bit for bit; the hand-offs are the cross-owner hops of the paths, at 80
    bytes each, measured equal to analytic."""
    got = local(medium, parts[k], k, transport=transport, exchange_cap=cap)
    assert_same_walks(got, dense, f"k={k} {transport}")
    assert int(got.msg_count) == hops(got.path.numpy(), parts[k])
    assert float(got.msg_bytes) == float(got.msg_bytes_analytic) == \
        incom.MSG_BYTES * int(got.msg_count)


def test_spill_rounds_with_tiny_exchange_cap(medium, parts, dense):
    """cap = 1 forces many spill rounds a superstep; the walks and the
    measured traffic do not change."""
    tiny, stats = local(medium, parts[4], 4, transport="gather", exchange_cap=1,
                        with_stats=True)
    assert_same_walks(tiny, dense)
    assert int(tiny.msg_count) == hops(tiny.path.numpy(), parts[4])
    assert float(tiny.msg_bytes) == incom.MSG_BYTES * int(tiny.msg_count)
    assert stats["spill_rounds"] > tiny.supersteps
    assert stats["host_reads"] >= stats["spill_rounds"]


def test_shard_stats_surface_balance(plain, parts, reference_runs, monkeypatch):
    """``with_stats`` exposes per-shard supersteps, hand-offs, occupancy and
    CSR bytes, so balance skew is visible: at k = 4 (MPGP, one pool retry)
    they are the reference's, entry for entry."""
    monkeypatch.setattr(shard_engine, "_POOL_CACHE", {})
    k, kw = REF_RUNS[2]
    st, stats = run_walk_sharded(plain, torch.arange(LANES), keys_of(5),
                                 make_policy("deepwalk"), WalkSpec(**FIXED), parts[k], k,
                                 engine="local", with_stats=True, **kw)
    for key in ("supersteps", "msg_count", "peak_lane_occupancy", "final_lane_occupancy",
                "owned_nodes", "csr_bytes_per_shard"):
        assert len(stats[key]) == k, key
        assert stats[key] == reference_runs[2][1][key], key
    assert max(stats["supersteps"]) == st.supersteps
    assert sum(stats["owned_nodes"]) == plain.num_nodes
    assert stats["pool_retries"] == 1
    assert all(v <= stats["pool_slots"] for v in stats["peak_lane_occupancy"])


def test_pool_overflow_grows_and_recovers(medium, parts, dense):
    """An undersized slot pool overflows; the driver doubles it and runs
    again, and the walks are unchanged."""
    small, stats = local(medium, parts[4], 4, pool_factor=0.05, with_stats=True)
    assert_same_walks(small, dense)
    assert stats["pool_retries"] >= 1
    assert stats["pool_slots"] > 0.05 * LANES / 4


def test_returning_walker_revives_ghost_slot():
    """Walkers that cross between two shards every superstep revive their
    own ghost slots (at pool == B no free slot exists once every lane left
    a ghost); the walks equal the dense engine's and no pool overflows."""
    g = build_csr(np.array([[0, 1], [2, 3]]), num_nodes=4, device="cpu")
    part = np.array([0, 1, 0, 1])
    spec = WalkSpec(max_len=12, min_len=4, mu=-1.0, info_mode="incom", reg_start=16)
    keys = lambda: LaneKeys.of([prng.PRNGKey(3)], 4, 4, "cpu")
    dense = run_walk_batch(g, torch.arange(4), keys(), make_policy("deepwalk"), spec)
    st, stats = run_walk_sharded(g, torch.arange(4), keys(), make_policy("deepwalk"), spec,
                                 part, 2, engine="local", pool_factor=10.0, with_stats=True)
    assert_same_walks(st, dense)
    assert stats["pool_slots"] == 4 and stats["pool_retries"] == 0
    assert int(st.msg_count) >= 4 * (spec.max_len - 2)     # every step a hand-off


def test_partitioned_csr_cache_reuses(medium, parts):
    a = partitioned_csr_for(medium, parts[4], 4)
    assert partitioned_csr_for(medium, parts[4], 4) is a
    assert partitioned_csr_for(medium, parts[2], 2) is not a


def test_no_tensor_grows_as_pool_times_records(medium, monkeypatch):
    """At B = 4,096 lanes on 2 shards (pool P = B, 8,192 records a round
    under the pool transport) the reference's (P, records) match would be a
    33.5 M-entry tensor. The port's largest is a lane-indexed store, (k, B
    + 1, max_len); every tensor the engine makes is recorded."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    lanes, k = 4096, 2
    spec = WalkSpec(max_len=8, info_mode="fixed", fixed_len=8)
    part = mpgp.hash_partition(medium, k).assignment
    with Largest():
        st, stats = local(medium, part, k, spec=spec, lanes=lanes, policy="deepwalk",
                          transport="pool", with_stats=True)
    p = stats["pool_slots"]
    assert p == lanes and int(st.msg_count) > 0
    store = k * (lanes + 1) * spec.max_len
    assert Largest.numel <= store < p * k * p // 100, (Largest.numel, store)


# --- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test holds the engines on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine,k,partitioner", [
    ("replicated", 2, "mpgp_partition"), ("replicated", 4, "hash_partition"),
    ("local", 2, "mpgp_partition"), ("local", 4, "mpgp_partition"),
    ("local", 4, "hash_partition")])
def test_engines_equal_dense_engine_on_the_card(cuda_device, engine, k, partitioner):
    """A 65,536-node R-MAT graph, 65,536 HuGE + InCoM walks: both engines at
    k = 2 and 4 draw the dense engine's walks on the card, bit for bit,
    with a hand-off for every cross-owner hop (MPGP may cut no arc of an
    R-MAT graph at k = 2; the hash partition cuts most)."""
    graph = rmat_graph(65_536, 10, seed=1, device=cuda_device).with_edge_cm()
    part = getattr(mpgp, partitioner)(graph, k).assignment
    n = graph.num_nodes
    keys = lambda: LaneKeys.for_round(prng.PRNGKey(4), 0, n, cuda_device)
    spec = WalkSpec(max_len=100, min_len=20, mu=0.995, info_mode="incom", reg_start=16)
    sources = torch.arange(n, device=cuda_device)
    dense = run_walk_batch(graph, sources, keys(), make_policy("huge"), spec)
    got = run_walk_sharded(graph, sources, keys(), make_policy("huge"), spec, part, k,
                           engine=engine)
    assert torch.equal(got.path, dense.path)
    for f in INFO:
        assert torch.equal(getattr(got.info, f), getattr(dense.info, f)), f
    assert (got.supersteps, int(got.accepts), int(got.rejects)) == \
        (dense.supersteps, int(dense.accepts), int(dense.rejects))
    assert int(got.msg_count) == hops(got.path.cpu().numpy(), part)
    assert float(got.msg_bytes) == float(got.msg_bytes_analytic) == \
        incom.MSG_BYTES * int(got.msg_count)
    if partitioner == "hash_partition":
        assert int(got.msg_count) > 0
