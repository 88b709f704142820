"""Training health watchdog: detect divergence, drive rollback + backoff
(the JAX package's ``runtime/health.py``, copied).

Snapshots make crashes survivable; a *silent* divergence — NaN from a bad
reduction, a loss blow-up from an optimizer spike — survives every crash
protocol because nothing crashes: the poisoned phi just keeps training and
the damage shows up later as a bad AUC. This module is the detection half
of the self-healing loop:

* a checked training chunk (``core.dsgl.train_chunk_checked_in_place``;
  on the card the same CUDA graph as an unchecked chunk) reduces five
  device scalars after the chunk (non-finite counts over phi and the chunk
  losses, the loss sum, the update Frobenius norm, the phi norm) — one
  host pull of five scalars per check;
* ``HealthMonitor`` consumes them on the host at a deterministic cadence
  (keyed off ``global_step``, so a rolled-back replay re-checks the same
  windows), maintains loss / update-norm EMAs, and raises
  ``DivergenceError`` on a non-finite observation or an EMA spike;
* ``StreamingEmbedPipeline`` catches the error, restores the last
  consistent snapshot IN PLACE, scales the learning rate down by
  ``lr_backoff`` (persisted — a resumed process keeps the backoff), and
  quarantines the offending ring slots by re-walking their roots under the
  original round keys before resuming the run loop.

Detection latency is bounded by ``check_every`` training steps; the
monitor records it (steps between the last clean check and the detection).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import obs


class DivergenceError(RuntimeError):
    """Training diverged; carries the triggering ``HealthReport``."""

    def __init__(self, report: "HealthReport"):
        super().__init__(
            f"training divergence ({report.kind}) at step {report.step}: "
            f"loss={report.loss:.4g} ema={report.loss_ema:.4g} "
            f"nonfinite={report.nonfinite}")
        self.report = report


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One divergence verdict: what tripped, where, and which ring slots
    the diverging chunk was trained from (the quarantine set)."""

    kind: str                   # "nonfinite" | "loss_spike" | "update_spike"
    step: int                   # global_step AFTER the offending chunk
    loss: float
    loss_ema: float
    nonfinite: int
    update_norm: float
    slots: np.ndarray           # ring slots gathered by the offending chunk
    detection_steps: int        # steps since the previous clean check


@dataclasses.dataclass
class HealthConfig:
    """Watchdog thresholds (the JAX package's defaults)."""

    check_every: int = 1        # check cadence in GLOBAL STEPS (lifetimes);
                                # a chunk is checked when it crosses a
                                # multiple, so cadence survives replay
    ema_beta: float = 0.8       # loss / update-norm EMA decay per check
    spike_factor: float = 4.0   # loss > factor * EMA → divergence
    update_spike_factor: float = 0.0   # same gate on update norm (0 = off,
                                       # the norm is still tracked/reported)
    warmup_checks: int = 3      # EMA burn-in before the spike gates arm
    lr_backoff: float = 0.5     # lr multiplier applied per rollback
    max_rollbacks: int = 3      # give up (re-raise) after this many


@dataclasses.dataclass
class HealthMonitor:
    """Host-side divergence detector fed by the checked chunks.

    The monitor is pure bookkeeping — it never touches device state. The
    pipeline owns the reaction (rollback / backoff / quarantine) and calls
    ``note_rollback`` so ``report()`` carries the full healing history for
    benchmarks and operators.
    """

    cfg: HealthConfig = dataclasses.field(default_factory=HealthConfig)

    def __post_init__(self):
        self.loss_ema: Optional[float] = None
        self.update_ema: Optional[float] = None
        self.checks = 0
        self.detections: List[HealthReport] = []
        self.rollbacks = 0
        self.quarantined_slots = 0
        self._last_check_step = 0

    # -- cadence -----------------------------------------------------------
    def due(self, global_step: int, count: int) -> bool:
        """Should the chunk covering steps [global_step, global_step+count)
        run through the checked path? Deterministic in ``global_step`` so a
        rolled-back replay re-checks the exact same windows."""
        ce = max(self.cfg.check_every, 1)
        return (global_step // ce) != ((global_step + count) // ce)

    # -- observation -------------------------------------------------------
    def observe(self, stats: Dict[str, Any], *, step: int, count: int,
                slots: np.ndarray) -> None:
        """Digest one checked chunk's reductions; raise ``DivergenceError``
        on a non-finite observation or an EMA spike.

        ``stats`` are the device scalars of ``chunk_health``, on the host;
        ``count`` the chunk's step count (losses are normalized per step so
        the EMA is chunk-size invariant); ``slots`` the ring slots the
        chunk gathered (the quarantine candidates on divergence).
        """
        cfg = self.cfg
        self.checks += 1
        nonfinite = int(stats["nonfinite"]) + int(stats["loss_nonfinite"])
        loss = float(stats["loss_sum"]) / max(count, 1)
        update = float(stats["update_norm"])
        detection_steps = step - self._last_check_step

        # Telemetry piggybacks on the scalars already pulled to host for
        # the verdict — no additional device syncs.
        obs.inc("health.checks")
        obs.set_gauge("health.loss", loss)
        obs.set_gauge("health.update_norm", update)
        obs.set_gauge("health.phi_norm", float(stats.get("phi_norm", 0.0)))
        obs.set_gauge("health.nonfinite", nonfinite)

        kind = None
        if nonfinite > 0:
            kind = "nonfinite"
        elif (self.loss_ema is not None
                and self.checks > cfg.warmup_checks
                and loss > cfg.spike_factor * max(self.loss_ema, 1e-12)):
            kind = "loss_spike"
        elif (cfg.update_spike_factor > 0
                and self.update_ema is not None
                and self.checks > cfg.warmup_checks
                and np.isfinite(update)
                and update > cfg.update_spike_factor
                * max(self.update_ema, 1e-12)):
            kind = "update_spike"

        if kind is not None:
            report = HealthReport(
                kind=kind, step=step, loss=loss,
                loss_ema=float(self.loss_ema or 0.0),
                nonfinite=nonfinite, update_norm=update,
                slots=np.asarray(slots), detection_steps=detection_steps)
            self.detections.append(report)
            obs.span_event("health.divergence", kind=kind, step=step,
                           loss=loss, nonfinite=nonfinite,
                           detection_steps=detection_steps)
            obs.inc(f"health.divergence.{kind}")
            obs.dump_flight_record(f"divergence_{kind}", kind=kind,
                                   step=step, loss=loss,
                                   nonfinite=nonfinite)
            raise DivergenceError(report)

        # Clean check: fold into the EMAs, advance the detection clock.
        b = cfg.ema_beta
        self.loss_ema = (loss if self.loss_ema is None
                         else b * self.loss_ema + (1 - b) * loss)
        if np.isfinite(update):
            self.update_ema = (update if self.update_ema is None
                               else b * self.update_ema + (1 - b) * update)
        self._last_check_step = step

    # -- healing bookkeeping (called by the pipeline) ----------------------
    def note_rollback(self, *, restored_step: int, lr_scale: float,
                      quarantined: int) -> None:
        self.rollbacks += 1
        self.quarantined_slots += int(quarantined)
        obs.span_event("health.rollback", restored_step=restored_step,
                       lr_scale=lr_scale, quarantined=int(quarantined))
        obs.inc("health.rollbacks")
        # Replay restarts below the EMA's reference point; reset the
        # detection clock so latency accounting stays truthful.
        self._last_check_step = restored_step

    def exhausted(self) -> bool:
        return self.rollbacks >= self.cfg.max_rollbacks

    def report(self) -> Dict[str, Any]:
        """Operator/benchmark summary of the watchdog's run."""
        return {
            "checks": self.checks,
            "detections": len(self.detections),
            "rollbacks": self.rollbacks,
            "quarantined_slots": self.quarantined_slots,
            "loss_ema": self.loss_ema,
            "update_ema": self.update_ema,
            "detection_kinds": [d.kind for d in self.detections],
            "detection_steps": [d.detection_steps for d in self.detections],
        }


# ---------------------------------------------------------------------------
# Snapshot admission gate (serve-side health, for the embedding server)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SnapshotGateConfig:
    """Admission thresholds for candidate serving snapshots.

    The serve-side sibling of ``HealthConfig``: instead of watching
    per-chunk training reductions, the gate judges a whole candidate
    embedding table before it can reach readers. The norm-spike gate uses
    the same EMA-vs-factor shape as ``HealthMonitor`` so the two halves of
    the health story tune the same way.
    """

    min_mean_norm: float = 1e-8     # below → degenerate (all-zero) table
    spike_factor: float = 8.0       # mean norm > factor * EMA → reject;
                                    # < EMA / factor → reject (collapse)
    ema_beta: float = 0.8           # EMA decay over ADMITTED snapshots
    warmup_admits: int = 1          # admitted snapshots before spike arms


@dataclasses.dataclass
class SnapshotGate:
    """Health-gate a candidate embedding snapshot before a serve swap.

    Checks, in order: every phi entry finite; embedding version strictly
    monotonic (a re-published or rolled-back step must not regress
    readers); graph_version monotonic (serving must never step back to a
    pre-churn graph); mean row norm above ``min_mean_norm`` and within
    ``spike_factor`` of the EMA over previously-admitted snapshots. A
    divergent refresh that escaped the training watchdog is stopped here —
    the last line of defense before readers.

    ``admit`` returns ``(ok, reason)`` and never raises: the server owns
    the reaction (keep serving the active version, count the rejection).
    """

    cfg: SnapshotGateConfig = dataclasses.field(
        default_factory=SnapshotGateConfig)

    def __post_init__(self):
        self.norm_ema: Optional[float] = None
        self.admits = 0
        self.last_version: Optional[int] = None
        self.last_graph_version: Optional[int] = None
        self.rejections: List[Dict[str, Any]] = []

    def admit(self, phi: np.ndarray, *, version: int,
              graph_version: int = 0) -> tuple:
        cfg = self.cfg
        phi = np.asarray(phi)
        reason = None
        mean_norm = 0.0
        if not np.all(np.isfinite(phi)):
            reason = "nonfinite_phi"
        elif self.last_version is not None and version <= self.last_version:
            reason = "version_regression"
        elif (self.last_graph_version is not None
                and graph_version < self.last_graph_version):
            reason = "graph_version_regression"
        else:
            mean_norm = float(
                np.linalg.norm(phi.reshape(phi.shape[0], -1), axis=1).mean())
            if mean_norm < cfg.min_mean_norm:
                reason = "degenerate_norm"
            elif (self.norm_ema is not None
                    and self.admits >= cfg.warmup_admits
                    and not (self.norm_ema / cfg.spike_factor
                             <= mean_norm
                             <= self.norm_ema * cfg.spike_factor)):
                reason = "norm_spike"

        if reason is not None:
            rec = {"reason": reason, "version": int(version),
                   "graph_version": int(graph_version),
                   "mean_norm": mean_norm}
            self.rejections.append(rec)
            obs.span_event("serve.gate.reject", **rec)
            obs.inc(f"serve.gate.rejected.{reason}")
            return False, reason

        b = cfg.ema_beta
        self.norm_ema = (mean_norm if self.norm_ema is None
                         else b * self.norm_ema + (1 - b) * mean_norm)
        self.admits += 1
        self.last_version = int(version)
        self.last_graph_version = int(graph_version)
        obs.inc("serve.gate.admitted")
        return True, None
