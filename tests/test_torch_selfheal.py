"""The divergence watchdog of the port's streaming pipeline.

``tests/test_selfheal.py``'s watchdog cases on the port: the monitor's
step-keyed cadence, the non-finite verdict, the warm-up-gated spike gates,
the chunk-size-invariant EMA and the rollback budget (and the same verdicts
as the reference's monitor on one sequence); in the pipeline, a checked run
bit-equal to an unchecked one, a NaN or a learning-rate spike caught,
rolled back to the newest snapshot with the learning rate backed off, the
offending roots walked again, and the run ending finite; at ``lr_backoff``
1.0 the healed run lands on the unchecked run's bits; the rollback restores
the snapshot bit for bit into phi's own storage; a spent budget re-raises;
the backoff survives a resume. On the card (``-m cuda``): a checked chunk
replays the unchecked chunk's CUDA graph and captures none, and a rollback
leaves the captured graphs valid.
"""

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import load_checkpoint
from repro_torch.core import dsgl
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.graph.generators import rmat_graph
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.health import (DivergenceError, HealthConfig, HealthMonitor,
                                        SnapshotGate)
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: Fixed-mode DeepWalk, short walks: six rounds, one 1-step chunk a round.
PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=6, dim=16,
            seed=3, rng_mode="vertex")
DSGL = dict(dim=16, seed=3)


def _plan():
    return (*make_walk_plan(EmbedConfig(**PLAN)), DSGLConfig(**DSGL))


def _pipeline(graph, **kw):
    return StreamingEmbedPipeline(graph, *_plan(), **kw)


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(128, 7, seed=7, device="cpu")


@pytest.fixture(scope="module")
def oracle(graph):
    """The unchecked, fault-free run: the bit-identity target."""
    p = _pipeline(graph)
    p.run()
    return p


def _same_run(a, b) -> bool:
    return (torch.equal(a.phi_in, b.phi_in) and torch.equal(a.phi_out, b.phi_out)
            and torch.equal(a.ring.walks, b.ring.walks))


# --- the monitor ------------------------------------------------------------


def _stats(loss=1.0, nonfinite=0, loss_nonfinite=0, update=0.1):
    return {"nonfinite": nonfinite, "loss_nonfinite": loss_nonfinite, "loss_sum": loss,
            "update_norm": update, "phi_norm": 1.0}


class TestHealthMonitor:
    def test_cadence_is_step_keyed(self):
        mon = HealthMonitor(HealthConfig(check_every=10))
        assert not mon.due(0, 5)          # [0, 5) crosses no multiple of 10
        assert mon.due(5, 5) and mon.due(8, 20)
        assert mon.due(5, 5) and mon.due(5, 5)     # a replay re-checks the same window

    def test_nonfinite_raises_immediately(self):
        mon = HealthMonitor(HealthConfig())
        with pytest.raises(DivergenceError) as ei:
            mon.observe(_stats(nonfinite=3), step=1, count=1, slots=np.array([0, 1]))
        assert ei.value.report.kind == "nonfinite" and ei.value.report.nonfinite == 3

    def test_loss_spike_gated_by_warmup(self):
        mon = HealthMonitor(HealthConfig(spike_factor=4.0, warmup_checks=3))
        for s in range(3):               # during warm-up a spike only moves the EMA
            mon.observe(_stats(loss=100.0 if s == 1 else 1.0), step=s + 1, count=1,
                        slots=np.zeros(1, np.int64))
        for s in range(3, 8):
            mon.observe(_stats(loss=1.0), step=s + 1, count=1, slots=np.zeros(1, np.int64))
        with pytest.raises(DivergenceError) as ei:
            mon.observe(_stats(loss=1e3), step=9, count=1, slots=np.zeros(1, np.int64))
        assert ei.value.report.kind == "loss_spike" and ei.value.report.detection_steps >= 1

    def test_loss_ema_is_chunk_size_invariant(self):
        a, b = HealthMonitor(HealthConfig()), HealthMonitor(HealthConfig())
        a.observe(_stats(loss=2.0), step=1, count=1, slots=np.zeros(1, np.int64))
        b.observe(_stats(loss=8.0), step=4, count=4, slots=np.zeros(1, np.int64))
        assert a.loss_ema == pytest.approx(b.loss_ema)

    def test_rollback_budget_exhausts(self):
        mon = HealthMonitor(HealthConfig(max_rollbacks=2))
        assert not mon.exhausted()
        mon.note_rollback(restored_step=0, lr_scale=0.5, quarantined=4)
        mon.note_rollback(restored_step=0, lr_scale=0.25, quarantined=4)
        assert mon.exhausted()
        rep = mon.report()
        assert rep["rollbacks"] == 2 and rep["quarantined_slots"] == 8

    def test_verdicts_and_emas_match_the_reference(self):
        from repro.runtime.health import DivergenceError as RefDivergence
        from repro.runtime.health import HealthConfig as RefConfig
        from repro.runtime.health import HealthMonitor as RefMonitor

        kw = dict(warmup_checks=2, spike_factor=4.0, update_spike_factor=50.0)
        mine, ref = HealthMonitor(HealthConfig(**kw)), RefMonitor(RefConfig(**kw))
        seq = [_stats(loss=1.0 + 0.1 * i, update=0.1 + 0.01 * i) for i in range(6)]
        seq += [_stats(update=100.0), _stats(loss=50.0), _stats(loss_nonfinite=1)]
        for i, st in enumerate(seq):
            verdicts = []
            for mon, err in ((mine, DivergenceError), (ref, RefDivergence)):
                try:
                    mon.observe(st, step=i + 1, count=1, slots=np.arange(3))
                    verdicts.append(None)
                except err as e:
                    verdicts.append(e.report.kind)
            assert verdicts[0] == verdicts[1], (i, verdicts)
            assert (mine.loss_ema, mine.update_ema) == (ref.loss_ema, ref.update_ema)
        assert mine.report() == ref.report()

    def test_snapshot_gate(self):
        gate = SnapshotGate()
        phi = np.ones((4, 3), np.float32)
        assert gate.admit(phi, version=1) == (True, None)
        assert gate.admit(phi, version=1) == (False, "version_regression")
        assert gate.admit(phi * np.nan, version=2) == (False, "nonfinite_phi")
        assert gate.admit(phi * 100, version=3) == (False, "norm_spike")
        assert gate.admit(phi * 0, version=4) == (False, "degenerate_norm")


# --- the watchdog in the training path ---------------------------------------


def test_checked_path_is_bit_identical(graph, oracle):
    """Checking every chunk changes no bit of training."""
    p = _pipeline(graph, health=HealthMonitor(HealthConfig()))
    p.run()
    assert _same_run(p, oracle)
    rep = p.health.report()
    assert rep["checks"] == p.checked_chunks == p.chunks == 6 and rep["detections"] == 0


@pytest.mark.parametrize("site,kind", [("phi_nan", "nonfinite"), ("lr_spike", "update_spike")])
def test_divergence_rolls_back_and_converges(graph, tmp_path, site, kind):
    # The lr spike blows the chunk's update norm up while the (saturating)
    # loss barely moves: the update gate catches it.
    mon = HealthMonitor(HealthConfig(check_every=1, warmup_checks=2, spike_factor=4.0,
                                     update_spike_factor=50.0, lr_backoff=0.5))
    p = _pipeline(graph, health=mon)
    res = p.run(ckpt_root=str(tmp_path / site), ckpt_every_rounds=1,
                faults=FaultInjector(inject_plan={site: [4]}))
    rep = res["health"]
    assert rep["detections"] == 1 and rep["rollbacks"] == 1
    assert rep["detection_kinds"] == [kind]
    assert res["lr_scale"] == pytest.approx(0.5) and rep["quarantined_slots"] > 0
    assert torch.isfinite(p.phi_in).all() and torch.isfinite(p.phi_out).all()


def test_rollback_lands_on_the_fault_free_bits(graph, oracle, tmp_path):
    """At lr_backoff 1.0 the healed run equals the unchecked, fault-free run:
    the restore, the quarantine re-walk and the replay are all exact."""
    p = _pipeline(graph, health=HealthMonitor(HealthConfig(check_every=1, lr_backoff=1.0)))
    res = p.run(ckpt_root=str(tmp_path / "heal"), ckpt_every_rounds=1,
                faults=FaultInjector(inject_plan={"phi_nan": [3]}))
    assert res["health"]["rollbacks"] == 1
    assert _same_run(p, oracle)


def test_restore_in_place_restores_the_snapshot(graph, tmp_path):
    """The rollback copies the newest snapshot into phi's and the ring's own
    storage (a captured CUDA graph keeps pointing at live data), bit for
    bit, with every cursor."""
    root = str(tmp_path / "ckpt")
    p = _pipeline(graph)
    p.run(ckpt_root=root, ckpt_every_rounds=1)
    p._ckpt_root = root
    ptrs = (p.phi_in.data_ptr(), p.phi_out.data_ptr(), p.ring.walks.data_ptr())
    step, arrays, meta = load_checkpoint(root)
    p.phi_in.fill_(float("nan"))
    p.ring.walks.fill_(-1)
    p.global_step, p._phase = 0, "rounds"
    assert p._restore_in_place() == meta["global_step"]
    assert (p.phi_in.data_ptr(), p.phi_out.data_ptr(), p.ring.walks.data_ptr()) == ptrs
    np.testing.assert_array_equal(p.phi_in.numpy(), arrays["phi_in"])
    np.testing.assert_array_equal(p.phi_out.numpy(), arrays["phi_out"])
    np.testing.assert_array_equal(p.ring.walks.numpy(), arrays["ring/walks"])
    assert (p._phase, p._ckpt_seq) == (meta["phase"], step + 1)


def test_rollback_budget_reraises(graph, tmp_path):
    p = _pipeline(graph, health=HealthMonitor(HealthConfig(check_every=1, max_rollbacks=1)))
    with pytest.raises(DivergenceError):           # two poisonings, one rollback budgeted
        p.run(ckpt_root=str(tmp_path / "budget"), ckpt_every_rounds=1,
              faults=FaultInjector(inject_plan={"phi_nan": [3, 4]}))


def test_without_a_snapshot_root_the_verdict_propagates(graph):
    p = _pipeline(graph, health=HealthMonitor(HealthConfig(check_every=1)))
    with pytest.raises(DivergenceError):
        p.run(faults=FaultInjector(inject_plan={"phi_nan": [2]}))


def test_resume_persists_lr_backoff(graph, tmp_path):
    root = str(tmp_path / "persist")
    p = _pipeline(graph, health=HealthMonitor(HealthConfig(check_every=1, lr_backoff=0.5)))
    p.run(ckpt_root=root, ckpt_every_rounds=1,
          faults=FaultInjector(inject_plan={"phi_nan": [3]}))
    assert p._lr_scale == pytest.approx(0.5)
    policy, spec, _, dsgl_cfg = _plan()
    q = StreamingEmbedPipeline.resume(root, policy, spec, dsgl_cfg, device="cpu")
    assert q._lr_scale == pytest.approx(0.5)
    assert np.allclose(q._lrs(2), np.maximum(
        dsgl_cfg.lr * 0.5 * (1 - (q.global_step + np.arange(2)) / q.total_steps),
        dsgl_cfg.min_lr))


# --- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_checked_chunk_replays_the_unchecked_graph_on_the_card(cuda_device):
    """A checked chunk copies phi into the pipeline's pre-chunk buffers and
    replays the graph an unchecked chunk replays: phi bit-equal, no graph
    captured for checking, one replay a chunk."""
    g = rmat_graph(128, 7, seed=7, device=cuda_device)
    plain = _pipeline(g)
    replays = dsgl.GRAPH_REPLAYS
    plain.run()
    plain_replays = dsgl.GRAPH_REPLAYS - replays
    checked = _pipeline(g, health=HealthMonitor(HealthConfig(check_every=1)))
    replays = dsgl.GRAPH_REPLAYS
    checked.run()
    assert dsgl.GRAPH_REPLAYS - replays == plain_replays == checked.chunks
    assert checked.checked_chunks == checked.chunks
    assert len(checked._graphs._graphs) == len(plain._graphs._graphs)
    assert _same_run(plain, checked)


@pytest.mark.cuda
def test_rollback_keeps_the_captured_graphs_valid_on_the_card(cuda_device, tmp_path):
    """A rollback copies the snapshot into phi's storage: the graphs captured
    before it replay on after it (none is captured again), and at
    lr_backoff 1.0 the healed run equals the fault-free one bit for bit."""
    g = rmat_graph(128, 7, seed=7, device=cuda_device)
    plain = _pipeline(g)
    plain.run()
    p = _pipeline(g, health=HealthMonitor(HealthConfig(check_every=1, lr_backoff=1.0)))
    ptr = p.phi_in.data_ptr()
    res = p.run(ckpt_root=str(tmp_path / "heal"), ckpt_every_rounds=1,
                faults=FaultInjector(inject_plan={"phi_nan": [3]}))
    assert res["health"]["rollbacks"] == 1 and p.phi_in.data_ptr() == ptr
    assert len(p._graphs._graphs) == len(plain._graphs._graphs)
    assert _same_run(plain, p)
