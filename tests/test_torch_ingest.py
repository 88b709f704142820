"""The port's ingest driver (``repro_torch.runtime.ingest``): the
write-ahead log, the driver's protocol, its crash recovery and its
degrade ladder, and their telemetry.

The WAL's round trip, a torn tail and a garbage file; the record bytes
are the reference's, and each package replays (and truncates) the log the
other wrote. The driver, on ``tests/test_recovery.py``'s and
``tests/test_selfheal.py``'s cases: submit / drain / staleness,
backpressure, a crash after durable appends recovered from disk to the
uninterrupted drain's bits, a torn append never acknowledged, a refresh
that fails, restores in place and retries to the clean drain's bits or
exhausts its retries, validation before the WAL, the SLO ladder with its
debt. One scenario (a retried drain, the ladder) runs in both packages:
the same modes and refresh counts, and the same ``ingest.*`` counters,
gauges and histograms (the elastic ``pipeline.*`` ones are compared in
``tests/test_torch_elastic.py``). The chaos sweep at
seed 0 ends on the fault-free ring and phi. On the card (``-m cuda``): a
retried drain leaves no more device memory allocated than a clean one.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.core.mpgp import mpgp_partition
from repro_torch.graph.delta import EdgeBatch
from repro_torch.graph.generators import rmat_graph
from repro_torch.runtime.faults import FaultInjector, LivenessProbe, SimulatedFailure
from repro_torch.runtime.health import HealthConfig, HealthMonitor
from repro_torch.runtime.ingest import IngestConfig, IngestDriver, WriteAheadLog
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: Fixed-mode DeepWalk with short walks (bit-exact walks in both packages).
PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=6, dim=16,
            seed=3, rng_mode="vertex")
DSGL = dict(dim=16, seed=3)


def _plan():
    return (*make_walk_plan(EmbedConfig(**PLAN)), DSGLConfig(**DSGL))


def _pipeline(graph, **kw):
    return StreamingEmbedPipeline(graph, *_plan(), **kw)


def _trained(graph, **kw):
    p = _pipeline(graph, **kw)
    p.run()
    return p


def _batches(n, seed, num_nodes=128, k=6, weights=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        e = rng.integers(0, num_nodes, size=(k, 2))
        e = e[e[:, 0] != e[:, 1]]
        out.append(EdgeBatch(insert=e, delete=rng.integers(0, num_nodes, size=(2, 2)),
                             insert_weights=rng.random(len(e)).astype(np.float32)
                             if weights else None))
    return out


def _recover(root, p, **kw):
    policy, spec, _, dsgl = _plan()
    return IngestDriver.recover(root, policy, spec, dsgl, device="cpu", **kw)


def _same_state(a, b) -> bool:
    return (torch.equal(a.phi_in, b.phi_in) and torch.equal(a.phi_out, b.phi_out)
            and torch.equal(a.ring.walks, b.ring.walks) and torch.equal(a.ring.ocn, b.ring.ocn)
            and a.graph.num_edges == b.graph.num_edges)


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(128, 7, seed=7, device="cpu")


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.reset()
    yield
    obs.reset()


# --- the write-ahead log ----------------------------------------------------------


def _same_batch(got, want):
    np.testing.assert_array_equal(got.insert, want.insert)
    np.testing.assert_array_equal(got.delete, want.delete)
    if want.insert_weights is None:
        assert got.insert_weights is None
    else:
        np.testing.assert_array_equal(got.insert_weights, want.insert_weights)


def test_append_replay_truncate(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    batches = _batches(3, seed=5)
    for i, b in enumerate(batches, start=1):
        wal.append(i, b)
    assert wal.last_append["bytes"] > 0 and wal.last_append["fsync_s"] >= 0
    recs, _ = wal.replay()
    assert [s for s, _ in recs] == [1, 2, 3]
    for (_, got), want in zip(recs, batches):
        _same_batch(got, want)
    assert [s for s, _ in wal.replay(after_seq=2)[0]] == [3]
    wal.truncate_upto(2)
    assert [s for s, _ in wal.replay()[0]] == [3]
    wal.truncate_upto(3)
    assert wal.replay() == ([], 0)


def test_torn_tail_detected(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    b1, b2 = _batches(2, seed=5)
    wal.append(1, b1)
    with pytest.raises(SimulatedFailure):
        wal.append(2, b2, faults=FaultInjector(torn_plan={"wal": [0]}))
    assert [s for s, _ in wal.replay()[0]] == [1]
    wal.truncate_upto(0)                     # rewrites the valid prefix only
    recs, size = wal.replay()
    assert [s for s, _ in recs] == [1] and size == os.path.getsize(wal.path)


def test_garbage_file_is_all_torn(tmp_path):
    path = str(tmp_path / "wal.log")
    with open(path, "wb") as f:
        f.write(b"not a wal record at all")
    assert WriteAheadLog(path).replay() == ([], 0)


@pytest.fixture
def fixed_zip_clock(monkeypatch):
    """np.savez stamps each npz member with the wall clock: pin it, so two
    writes of one batch give one byte string."""
    import types
    import time as _time

    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=_time.localtime))


def test_records_are_the_references_bytes(tmp_path, fixed_zip_clock):
    from repro.graph.delta import EdgeBatch as RefBatch
    from repro.runtime.ingest import WriteAheadLog as RefWAL

    batches = _batches(2, seed=7) + _batches(1, seed=8, weights=True)
    mine, ref = WriteAheadLog(str(tmp_path / "a.log")), RefWAL(str(tmp_path / "b.log"))
    for i, b in enumerate(batches, start=1):
        mine.append(i, b)
        ref.append(i, RefBatch(insert=b.insert, delete=b.delete, insert_weights=b.insert_weights))
    with open(mine.path, "rb") as f, open(ref.path, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    from repro.graph.delta import EdgeBatch as RefBatch
    from repro.runtime.ingest import WriteAheadLog as RefWAL

    batches = _batches(2, seed=9) + _batches(1, seed=10, weights=True)
    path = str(tmp_path / "wal.log")
    w, r = (WriteAheadLog(path), RefWAL(path)) if writer == "port" else \
        (RefWAL(path), WriteAheadLog(path))
    for i, b in enumerate(batches, start=1):
        w.append(i, b if writer == "port" else
                 RefBatch(insert=b.insert, delete=b.delete, insert_weights=b.insert_weights))
    with open(path, "ab") as f:
        f.write(b"\x07torn")                 # a torn header after the records
    recs, size = r.replay(after_seq=1)
    assert [s for s, _ in recs] == [2, 3] and size == os.path.getsize(path) - 5
    for (_, got), want in zip(recs, batches[1:]):
        _same_batch(got, want)
    r.truncate_upto(2)
    assert [s for s, _ in w.replay()[0]] == [3]


# --- the driver -------------------------------------------------------------------


def test_submit_drain_staleness(graph, tmp_path):
    drv = IngestDriver(str(tmp_path / "a"), _trained(graph), cfg=IngestConfig(apply_every=2))
    b1, b2, b3 = _batches(3, seed=5)
    drv.submit(b1)
    st = drv.staleness()
    assert st["pending_batches"] == 1 and st["applied_seq"] == 0
    assert st["oldest_pending_age_s"] is not None
    drv.submit(b2)                           # the cadence: a drain
    st = drv.staleness()
    assert st["pending_batches"] == 0 and st["applied_seq"] == st["appended_seq"] == 2
    assert st["drains"] == 1 and st["mode_counts"]["full"] == 1
    assert drv.wal.replay() == ([], 0)
    drv.submit(b3)
    assert drv.staleness()["pending_batches"] == 1


def test_snapshot_meta_carries_applied_seq(graph, tmp_path):
    from repro_torch.ckpt.checkpoint import read_meta

    root = str(tmp_path / "meta")
    drv = IngestDriver(root, _trained(graph), cfg=IngestConfig(apply_every=1))
    assert read_meta(drv.ckpt_dir)[1]["applied_seq"] == 0
    drv.submit(_batches(1, seed=4)[0])
    step, meta = read_meta(drv.ckpt_dir)
    assert meta["applied_seq"] == 1 and meta["ingest"] is True
    assert meta["kind"] == "streaming_pipeline" and step == drv.pipeline._ckpt_seq - 1


def test_staleness_backpressure(graph, tmp_path):
    drv = IngestDriver(str(tmp_path / "b"), _trained(graph),
                       cfg=IngestConfig(apply_every=100, max_pending_edges=4))
    drv.submit(_batches(1, seed=6, k=8)[0])  # more than 4 pending edges: drained
    assert drv.staleness()["pending_batches"] == 0


def test_crash_recovery_equals_uninterrupted(graph, tmp_path):
    root = str(tmp_path / "c")
    drv = IngestDriver(root, _trained(graph), cfg=IngestConfig(apply_every=10))
    for b in _batches(2, seed=7):
        drv.submit(b)                        # durable in the WAL, not applied
    assert drv.staleness()["pending_batches"] == 2
    # The process dies here: recover from the disk alone.
    rec = _recover(root, drv.pipeline)
    assert rec.staleness()["applied_seq"] == 2 and rec.staleness()["pending_batches"] == 0
    drv.drain()
    assert _same_state(drv.pipeline, rec.pipeline)


def test_crash_after_a_durable_append_recovers_to_the_clean_drain(graph, tmp_path):
    (b,) = _batches(1, seed=12)
    clean = IngestDriver(str(tmp_path / "clean"), _trained(graph),
                         cfg=IngestConfig(apply_every=1))
    clean.submit(b)
    root = str(tmp_path / "crash")
    drv = IngestDriver(root, _trained(graph), cfg=IngestConfig(apply_every=1),
                       faults=FaultInjector({"wal_append": [0]}))
    with pytest.raises(SimulatedFailure):
        drv.submit(b)
    assert drv.appended_seq == 1 and drv.applied_seq == 0
    rec = _recover(root, drv.pipeline, cfg=IngestConfig(apply_every=1))
    assert rec.applied_seq == rec.appended_seq == 1
    assert _same_state(clean.pipeline, rec.pipeline)


def test_torn_wal_append_not_acknowledged(graph, tmp_path):
    root = str(tmp_path / "d")
    p = _trained(graph)
    drv = IngestDriver(root, p, cfg=IngestConfig(apply_every=10),
                       faults=FaultInjector(torn_plan={"wal": [0]}))
    with pytest.raises(SimulatedFailure):
        drv.submit(_batches(1, seed=8)[0])
    assert os.path.getsize(drv.wal.path) > 0
    rec = _recover(root, p)
    st = rec.staleness()
    assert st["appended_seq"] == st["applied_seq"] == 0
    assert rec.wal.replay() == ([], 0) and os.path.getsize(rec.wal.path) == 0


@pytest.mark.parametrize("point", ["refresh", "refresh_splice"])
def test_refresh_failure_restores_then_retries(graph, tmp_path, point):
    """The first attempt dies (at entry, or after its first round's splices
    landed): the driver restores the snapshot in place and retries, with
    backoff, to the clean drain's bits; phi keeps its storage."""
    (b,) = _batches(1, seed=9)
    delays = []
    p = _trained(graph)
    ptr = p.phi_in.data_ptr()
    drv = IngestDriver(str(tmp_path / "e"), p, cfg=IngestConfig(
        apply_every=1, max_retries=2, backoff_s=0.01), faults=FaultInjector({point: [0]}),
        sleep=delays.append)
    drv.submit(b)
    st = drv.staleness()
    assert st["applied_seq"] == 1 and st["retries"] == 1 and delays == [0.01]
    assert drv.pipeline is p and p.phi_in.data_ptr() == ptr
    clean = IngestDriver(str(tmp_path / "e_ref"), _trained(graph),
                         cfg=IngestConfig(apply_every=1))
    clean.submit(b)
    assert _same_state(clean.pipeline, drv.pipeline)


def test_refresh_failure_exhausts_retries(graph, tmp_path):
    p = _trained(graph)
    root = str(tmp_path / "f")
    drv = IngestDriver(root, p, cfg=IngestConfig(apply_every=1, max_retries=1, backoff_s=0.0),
                       faults=FaultInjector({"refresh": [0, 1]}), sleep=lambda s: None)
    with pytest.raises(SimulatedFailure):
        drv.submit(_batches(1, seed=10)[0])
    # The batch stays durable: a recovery absorbs it once the fault clears.
    assert _recover(root, p).staleness()["applied_seq"] == 1


def test_driver_rejects_before_the_wal(graph, tmp_path):
    drv = IngestDriver(str(tmp_path / "g"), _trained(graph),
                       cfg=IngestConfig(apply_every=10, self_loop_policy="forbid"))
    with pytest.raises(ValueError, match="outside"):
        drv.submit(EdgeBatch(insert=np.array([[0, 999]])))
    with pytest.raises(ValueError, match="self-loop"):
        drv.submit(EdgeBatch(insert=np.array([[3, 3]])))
    assert drv.staleness()["pending_batches"] == 0 and drv.appended_seq == 0
    assert drv.wal.replay()[0] == []


# --- the staleness SLO and its degrade ladder -----------------------------------------


def _slo_driver(graph, tmp_path, clock, **cfg_kw):
    return IngestDriver(str(tmp_path / "slo"), _trained(graph),
                        cfg=IngestConfig(apply_every=10, **cfg_kw), clock=clock)


def test_latency_percentiles(graph, tmp_path):
    t = [100.0]
    drv = _slo_driver(graph, tmp_path, lambda: t[0])
    for i, b in enumerate(_batches(3, seed=21)):
        drv.submit(b)
        t[0] += float(i + 1)
        drv.drain()
    s = drv.staleness()
    assert s["latency_p50_s"] == pytest.approx(2.0)
    assert s["latency_p99_s"] == pytest.approx(3.0, abs=0.1)
    assert s["oldest_pending_age_s"] is None
    assert obs.REGISTRY.snapshot()["histograms"]["ingest.latency_s"]["count"] == 3


def test_degrade_ladder_and_debt_payment(graph, tmp_path):
    t = [100.0]
    drv = _slo_driver(graph, tmp_path, lambda: t[0], staleness_slo_s=5.0, slo_headroom=1.5)
    b1, b2, b3 = _batches(3, seed=22)
    drv.submit(b1)
    t[0] += 1.0
    assert drv.drain().mode == "full" and drv.last_mode == "full"
    # full's and no_finetune's predicted walls exceed the budget: detect only.
    drv._wall_ema = {"full": 10.0, "no_finetune": 10.0}
    drv.submit(b2)
    t[0] += 1.0
    st = drv.drain()
    assert st.mode == "detect_only" and st.rewalk_walks == 0 and st.fine_tune_steps == 0
    debt = int(drv._debt.sum())
    assert debt > 0 and drv.staleness()["debt_roots"] == debt
    drv._wall_ema = {}                        # fast again: a full drain pays the debt
    drv.submit(b3)
    t[0] += 1.0
    st = drv.drain()
    assert st.mode == "full" and drv._debt is None and st.affected >= debt
    assert drv.staleness()["debt_roots"] == 0
    assert drv.staleness()["mode_counts"] == {"full": 2, "no_finetune": 0, "detect_only": 1}


def test_blown_budget_goes_detect_only(graph, tmp_path):
    t = [100.0]
    drv = _slo_driver(graph, tmp_path, lambda: t[0], staleness_slo_s=2.0)
    drv.submit(_batches(1, seed=23)[0])
    t[0] += 10.0
    assert drv.drain().mode == "detect_only"
    assert drv.staleness()["slo_violations"] == 1


def test_middle_rung_when_it_fits(graph, tmp_path):
    t = [100.0]
    drv = _slo_driver(graph, tmp_path, lambda: t[0], staleness_slo_s=5.0, slo_headroom=1.0)
    drv._wall_ema = {"full": 100.0, "no_finetune": 0.1}
    drv.submit(_batches(1, seed=24)[0])
    t[0] += 1.0
    st = drv.drain()
    assert st.mode == "no_finetune" and st.fine_tune_steps == 0 and st.extra_rounds == 0


def test_no_slo_always_full(graph, tmp_path):
    drv = _slo_driver(graph, tmp_path, lambda: 0.0)
    drv._wall_ema = {"full": 1e9}
    drv.submit(_batches(1, seed=25)[0])
    assert drv.drain().mode == "full" and drv.staleness()["staleness_slo_s"] is None


def test_detect_only_snapshot_is_recoverable(graph, tmp_path):
    t = [100.0]
    drv = _slo_driver(graph, tmp_path, lambda: t[0], staleness_slo_s=5.0)
    drv._wall_ema = {"full": 10.0, "no_finetune": 10.0}
    drv.submit(_batches(1, seed=26)[0])
    t[0] += 1.0
    assert drv.drain().mode == "detect_only"
    rec = _recover(str(tmp_path / "slo"), drv.pipeline)
    assert rec.pipeline.graph.num_edges == drv.pipeline.graph.num_edges
    assert rec.staleness()["pending_batches"] == 0


# --- one scenario in both packages ---------------------------------------------------

def _scenario(pkg: str, root: str):
    """A driver whose first drain fails once at a splice and retries, a
    detect-only drain under an SLO and a full drain paying its debt, in
    either package. Returns the registry's snapshot, each drain's mode and
    counts, and the driver's staleness report. (The elastic run's
    ``pipeline.*`` telemetry is compared in ``tests/test_torch_elastic.py``.)"""
    if pkg == "port":
        o, pipe_cls, drv_cls, cfg_cls = obs, StreamingEmbedPipeline, IngestDriver, IngestConfig
        faults_cls, batch_cls = FaultInjector, EdgeBatch
        g = rmat_graph(128, 7, seed=7, device="cpu")
        plan = _plan()
    else:
        from repro import obs as o
        from repro.core.api import EmbedConfig as RefEmbedConfig
        from repro.core.api import make_walk_plan as ref_plan
        from repro.core.dsgl import DSGLConfig as RefDSGLConfig
        from repro.graph.delta import EdgeBatch as batch_cls
        from repro.graph.generators import rmat_graph as ref_rmat
        from repro.runtime.faults import FaultInjector as faults_cls
        from repro.runtime.ingest import IngestConfig as cfg_cls
        from repro.runtime.ingest import IngestDriver as drv_cls
        from repro.runtime.trainer import StreamingEmbedPipeline as pipe_cls

        g = ref_rmat(128, 7, seed=7)
        plan = (*ref_plan(RefEmbedConfig(**PLAN)), RefDSGLConfig(**DSGL))
    o.reset()
    o.configure(enabled=True, clear_sinks=True)
    p = pipe_cls(g, *plan)
    p.run()
    t = [100.0]
    drv = drv_cls(os.path.join(root, "ing"), p,
                  cfg=cfg_cls(apply_every=10, staleness_slo_s=5.0, max_retries=1, backoff_s=0.0),
                  faults=faults_cls({"refresh_splice": [0]}), clock=lambda: t[0],
                  sleep=lambda s: None)
    drains = []
    for i, b in enumerate(_batches(3, seed=31)):
        drv._wall_ema = {"full": 10.0, "no_finetune": 10.0} if i == 1 else {}
        drv.submit(batch_cls(insert=b.insert, delete=b.delete))
        t[0] += 1.0
        st = drv.drain()
        drains.append((st.mode, st.affected, st.rewalk_walks, st.retained_rounds,
                       st.extra_rounds, st.fine_tune_steps))
    snap = o.REGISTRY.snapshot()
    o.reset()
    return snap, drains, drv.staleness()


def test_scenario_matches_the_reference(tmp_path):
    ref, ref_drains, ref_st = _scenario("reference", str(tmp_path / "ref"))
    got, drains, st = _scenario("port", str(tmp_path / "port"))
    assert drains == ref_drains
    assert [d[0] for d in drains] == ["full", "detect_only", "full"]
    for key in ("applied_seq", "appended_seq", "drains", "retries", "slo_violations",
                "mode_counts", "debt_roots", "latency_p50_s", "latency_p99_s"):
        assert st[key] == ref_st[key], key
    assert_same_telemetry(got, ref)
    for name in ("ingest.retries", "ingest.drains", "ingest.mode.full",
                 "ingest.mode.detect_only", "ingest.wal_bytes", "faults.fired.refresh_splice"):
        assert got["counters"][name] > 0, name
    assert got["histograms"]["ingest.latency_s"]["count"] == 3


def assert_same_telemetry(got, ref):
    """The same counter, gauge and histogram names, the same counter and
    gauge values, the same histogram counts (their values are times)."""
    assert sorted(got["counters"]) == sorted(ref["counters"])
    assert sorted(got["gauges"]) == sorted(ref["gauges"])
    assert sorted(got["histograms"]) == sorted(ref["histograms"])
    assert got["counters"] == ref["counters"]
    assert got["gauges"] == ref["gauges"]
    for name, want in ref["histograms"].items():
        assert got["histograms"][name]["count"] == want["count"], name


# --- the chaos sweep ----------------------------------------------------------------


def test_chaos_schedule_at_seed_0(graph, tmp_path):
    """The reference's sweep at seed 0 on the port: a shard's death and a
    divergence in one run, then ingest under deadline pressure. The run
    ends on the fault-free k = 4 run's ring and phi; the degraded pipeline
    takes a detect-only drain and a full one that pays the debt."""
    rng = np.random.default_rng(0)
    dead = int(rng.integers(0, 4))
    down_at = int(rng.integers(2, 5))
    site = ["phi_nan", "lr_spike"][int(rng.integers(0, 2))]
    inject_at = int(rng.integers(3, 6))
    part = mpgp_partition(graph, 4, tau_weight="degree").assignment
    oracle = _trained(graph, assignment=part, num_shards=4)

    mon = HealthMonitor(HealthConfig(check_every=1, warmup_checks=2, update_spike_factor=50.0,
                                     lr_backoff=1.0, max_rollbacks=4))
    p = _pipeline(graph, assignment=part, num_shards=4, health=mon)
    res = p.run(ckpt_root=str(tmp_path / "chaos"), ckpt_every_rounds=1,
                faults=FaultInjector(down_plan={dead: down_at}, inject_plan={site: [inject_at]}),
                liveness=LivenessProbe(num_shards=4, misses_to_dead=2))
    assert p.walk_shards == 3 and len(res["reconfigs"]) == 1
    assert res["health"]["detections"] >= 1 and res["health"]["rollbacks"] >= 1
    assert torch.equal(p.ring.walks, oracle.ring.walks)
    assert torch.equal(p.phi_in, oracle.phi_in) and torch.equal(p.phi_out, oracle.phi_out)

    t = [100.0]
    drv = IngestDriver(str(tmp_path / "chaos-ing"), p,
                       cfg=IngestConfig(apply_every=10, staleness_slo_s=5.0), clock=lambda: t[0])
    b1, b2 = _batches(2, seed=1)
    drv._wall_ema = {"full": 10.0, "no_finetune": 10.0}
    drv.submit(b1)
    t[0] += 1.0
    assert drv.drain().mode == "detect_only"
    drv._wall_ema = {}
    drv.submit(b2)
    t[0] += 1.0
    st = drv.drain()
    assert st.mode == "full" and drv._debt is None
    assert torch.isfinite(drv.pipeline.phi_in).all()


# --- on the card ------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_retry_holds_no_second_pipeline_on_the_card(cuda_device, tmp_path):
    """A drain whose first attempt dies after a splice restores in place and
    retries: the device then holds no more memory than a clean drain of the
    same batch leaves (within 5%), and phi is the clean drain's."""
    import gc

    g = rmat_graph(4096, 10, seed=3, device=cuda_device)
    (b,) = _batches(1, seed=9, num_nodes=4096, k=64)

    def drained(name, faults):
        """(device bytes the driver holds after its drain, phi on the host,
        retries)."""
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        drv = IngestDriver(str(tmp_path / name), _trained(g), cfg=IngestConfig(apply_every=1),
                           faults=faults, sleep=lambda s: None)
        drv.submit(b)
        torch.cuda.synchronize()
        out = (torch.cuda.memory_allocated() - base, drv.pipeline.phi_in.cpu(), drv.retries)
        del drv
        return out

    clean, clean_phi, _ = drained("clean", FaultInjector())
    retried, phi, retries = drained("retry", FaultInjector({"refresh_splice": [0]}))
    assert retries == 1 and torch.equal(phi, clean_phi)
    assert retried <= 1.05 * clean, (retried, clean)
