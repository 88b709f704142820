"""Fault-tolerant embedding serving, the JAX package's ``runtime/serve.py``
ported.

The read side of the ingest -> refresh -> snapshot loop: an
``EmbedServer`` on the continuous-batching slot-pool pattern (the wave
scheduler the LM ``runtime.server`` uses is ``wave_batches``), answering

* **pair scoring** -- ``(u, candidates)`` -> dot-product scores, the
  link-prediction primitive;
* **top-K over V** -- ``(u, k)`` -> the k highest-scoring vertices with
  self excluded, ties toward the lower id.

The contract is the reference's, case for case:

* **Versioned snapshot swap** -- the server holds version v (loaded from
  the crash-consistent snapshots through ``load_checkpoint``; torn steps
  are invisible and the newest valid one is used) and swaps v+1 in with a
  single pointer store. A wave captures its snapshot at formation, so a
  half-swapped read cannot be expressed.
* **Health-gated swap** -- a candidate must pass ``health.SnapshotGate``
  before it is eligible.
* **SLO-aware degraded reads** -- fresh -> stale-ok (keep serving v while
  the refresh is degraded, retrying or rejected; every response is
  stamped ``served_version`` / ``staleness_s``) -> shed (at admission,
  when the wave-wall EMA x headroom predicts a blown deadline, or the
  queue is full).
* **Fault drills** -- ``FaultInjector`` points ``swap`` (inside the swap
  window, before the commit), ``serve_wave`` (the wave is re-queued) and
  the ``queue_overflow`` corruption site; a terminal failure (nothing
  servable at all) dumps a flight record before raising.

Scoring is **order-pinned**: every score is the d products added left to
right with no FMA, so served scores equal the NumPy oracle
(``oracle_scores`` / ``oracle_topk``) bit for bit. On the card that is the
hand-written ``kernels/chain_dot`` kernel; for a server on the CPU it is
the kernel's plain version (``kernels/chain_dot/ref.py``). The replica
mean of a snapshot is taken with NumPy on the host, so the array the gate
admits is the array the oracle scores.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import load_checkpoint
from repro_torch.common.logging import get_logger
from repro_torch.device import resolve_device
from repro_torch.kernels.chain_dot import ops as chain_ops
from repro_torch.kernels.chain_dot import ref as chain_ref
from repro_torch.runtime.faults import NULL_INJECTOR, FaultInjector
from repro_torch.runtime.health import SnapshotGate, SnapshotGateConfig

log = get_logger("repro_torch.runtime.serve")


class ServeError(RuntimeError):
    """Terminal serve failure (no servable version exists)."""


# ---------------------------------------------------------------------------
# Slot-pool wave batching (shared with the LM server)
# ---------------------------------------------------------------------------

def wave_batches(items: Sequence, slots: int) -> Iterator[list]:
    """Yield consecutive waves of at most ``slots`` items: the refill
    order of a fixed slot pool fed from a queue (continuous batching)."""
    slots = max(int(slots), 1)
    for i in range(0, len(items), slots):
        yield list(items[i:i + slots])


# ---------------------------------------------------------------------------
# Order-pinned scoring + NumPy oracle
# ---------------------------------------------------------------------------

def chain_dot(a, b):
    """Dot product along the last axis: elementwise products, then an
    explicit left-to-right chain of adds (the oracle's half of the
    bit-reproducibility contract)."""
    prod = a * b
    acc = prod[..., 0]
    for j in range(1, prod.shape[-1]):
        acc = acc + prod[..., j]
    return acc


def _pair_scores(phi: torch.Tensor, u: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(B,) query nodes x (B, C) candidate ids -> (B, C) scores: the
    kernel on the card, its plain version on the CPU."""
    if phi.device.type == "cuda":
        return chain_ops.pair_scores(phi, u, cand)
    return chain_ref.pair_scores_ref(phi, u, cand)


def _topk(phi: torch.Tensor, u: torch.Tensor, k: int):
    """(B,) query nodes -> (values, int32 ids) of the k best vertices."""
    if phi.device.type == "cuda":
        scores = chain_ops.all_scores(phi, u)
    else:
        scores = chain_ref.all_scores_ref(phi, u)
    return chain_ref.topk_from_scores(scores, u, k)


def oracle_scores(phi: np.ndarray, u: int, candidates: np.ndarray) -> np.ndarray:
    """NumPy reference for pair scoring -- same chain, same order."""
    phi = np.asarray(phi, np.float32)
    cand = np.asarray(candidates)
    return chain_dot(phi[int(u)][None, :], phi[cand])


def oracle_topk(phi: np.ndarray, u: int, k: int):
    """NumPy reference for top-K: (values, ids), self excluded, ties
    broken toward the lower id (matching ``lax.top_k``)."""
    phi = np.asarray(phi, np.float32)
    scores = chain_dot(phi[int(u)][None, :], phi)
    scores[int(u)] = -np.inf
    ids = np.argsort(-scores, kind="stable")[:k]
    return scores[ids], ids


# ---------------------------------------------------------------------------
# Request / response / snapshot types
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Query:
    """One admitted read: pair scoring (``candidates``) or top-K (``k``)."""

    qid: int
    u: int
    candidates: Optional[np.ndarray] = None
    k: int = 0
    deadline_s: Optional[float] = None
    submit_t: float = 0.0


@dataclasses.dataclass
class Response:
    """Every response is stamped with the version that produced it and
    how stale that version is: a reader can always tell fresh from
    stale-ok."""

    qid: int
    u: int
    ids: np.ndarray             # candidate ids (echoed, int32) or top-K ids (int32)
    scores: np.ndarray          # float32
    served_version: int
    served_graph_version: int
    staleness_s: float
    freshness: str              # "fresh" | "stale"
    latency_s: float


@dataclasses.dataclass
class EmbedSnapshot:
    """One immutable servable version. ``phi`` lives on the server's
    device; waves capture the whole object by reference, so a swap can
    never tear a wave's read."""

    phi: torch.Tensor           # (N, d) float32 node embeddings
    version: int                # checkpoint step (snapshot sequence)
    graph_version: int
    global_step: int
    created_t: float            # server clock at swap commit


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 32       # slot-pool width per wave
    max_queue: int = 1024       # admission queue bound (overflow -> shed)
    default_deadline_s: Optional[float] = None   # per-request unless set
    headroom: float = 1.5       # predicted wait = waves x EMA x headroom
    ema_beta: float = 0.5       # wave-wall EMA decay (as IngestDriver)
    latency_window: int = 256   # response-latency percentile history


_UNSET = object()


class EmbedServer:
    """Versioned, SLO-aware embedding read path over one slot pool.

    Single writer (the ingest/refresh lifecycle offering snapshots), many
    readers (``submit`` + ``tick``). The active-version pointer, the queue
    and the ladder state share one lock; scoring runs outside it on the
    wave's captured snapshot. ``device`` holds the served phi and runs the
    scoring: the card by default (raises without one), ``"cpu"`` on
    request.
    """

    def __init__(self, cfg: ServeConfig = ServeConfig(), *,
                 gate: Optional[SnapshotGate] = None,
                 faults: FaultInjector = NULL_INJECTOR,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gate = gate or SnapshotGate(SnapshotGateConfig())
        self.faults = faults
        self.clock = clock
        self._lock = threading.Lock()
        self._queue: Deque[Query] = deque()
        self._active: Optional[EmbedSnapshot] = None
        self._next_qid = 0
        self._wave_ema: Optional[float] = None
        self._newer_pending = False     # a newer candidate exists but was
                                        # rejected (torn / unhealthy)
        self.refresh_state = "ok"       # "ok" | "degraded" | "failed"
        self.responses: Dict[int, Response] = {}
        # -- accounting ------------------------------------------------------
        self.admitted = 0
        self.served = 0
        self.shed: Dict[str, int] = {}
        self.swaps = 0
        self.rejected_candidates = 0
        self.wave_faults = 0
        self.served_by_version: Dict[int, int] = {}
        self.served_by_freshness = {"fresh": 0, "stale": 0}
        self._latency = obs.Histogram(window=max(cfg.latency_window, 1))
        obs.REGISTRY.attach("serve.latency_s", self._latency)

    # -- versioned snapshot swap --------------------------------------------
    def offer_snapshot(self, root: str, step: Optional[int] = None) -> bool:
        """Load, health-gate and (if admitted) atomically swap in the newest
        valid checkpoint under ``root``. Returns True on swap.

        Torn steps are invisible to the loader (it falls back to the newest
        valid one); a fallback that is not newer than the active version is
        a no-op. A candidate the gate rejects leaves the active version
        serving and marks the ladder stale. No active version and no
        servable candidate is terminal: flight-record dump + raise.
        """
        with obs.trace_span("serve.offer", root=str(root)):
            try:
                loaded, arrays, meta = load_checkpoint(root, step, only=("phi_in",))
            except (FileNotFoundError, OSError, ValueError) as e:
                obs.inc("serve.offer.unreadable")
                if self._active is None:
                    obs.dump_flight_record("serve_no_snapshot", root=str(root), error=str(e))
                    raise ServeError(f"no servable snapshot under {root}: {e}") from e
                log.warning("snapshot offer unreadable (%s); keeping version %d", e,
                            self._active.version)
                return False

            if self._active is not None and loaded <= self._active.version:
                # Re-offer of the active (or an older fallback after a torn
                # newer step): nothing to do, nothing unhealthy.
                obs.inc("serve.offer.not_newer")
                return False

            phi = np.asarray(arrays["phi_in"], np.float32)
            if phi.ndim == 3:           # (S, N, d) replicas -> node space
                phi = phi[0] if phi.shape[0] == 1 else phi.mean(axis=0)
            gv = int(meta.get("graph_version", 0))
            # The swap window: a crash here (drill point "swap") leaves the
            # previous version serving and the gate's monotonic record
            # untouched, so the same step can be re-offered.
            self.faults.fire("swap", note=loaded)
            ok, reason = self.gate.admit(phi, version=loaded, graph_version=gv)
            if not ok:
                self.rejected_candidates += 1
                if self._active is None:
                    obs.dump_flight_record("serve_candidate_rejected", root=str(root),
                                           version=loaded, gate_reason=reason)
                    raise ServeError(f"candidate snapshot {loaded} rejected ({reason}) "
                                     "with no active version to fall back to")
                with self._lock:
                    self._newer_pending = True
                log.warning("candidate snapshot %d rejected (%s); serving version %d stale",
                            loaded, reason, self._active.version)
                return False

            snap = EmbedSnapshot(
                phi=torch.from_numpy(np.ascontiguousarray(phi)).to(self.device),
                version=int(loaded), graph_version=gv,
                global_step=int(meta.get("global_step", 0)), created_t=self.clock())
            # The commit is a single pointer store under the lock.
            with self._lock:
                self._active = snap
                self._newer_pending = False
            self.swaps += 1
            obs.inc("serve.swaps")
            obs.set_gauge("serve.active_version", loaded)
            obs.set_gauge("serve.active_graph_version", gv)
            obs.span_event("serve.swap", version=loaded, graph_version=gv)
            return True

    def note_refresh(self, state: str) -> None:
        """Ingest-side refresh status feed: "ok" | "degraded" | "failed".
        Anything but "ok" moves responses to the stale-ok rung until the
        next successful swap."""
        assert state in ("ok", "degraded", "failed"), state
        with self._lock:
            self.refresh_state = state
        obs.inc(f"serve.refresh.{state}")

    def active_version(self) -> Optional[int]:
        with self._lock:
            return None if self._active is None else self._active.version

    def active_phi(self) -> Optional[np.ndarray]:
        with self._lock:
            snap = self._active
        if snap is None:
            return None
        phi = snap.phi.cpu()
        return (phi.clone() if phi is snap.phi else phi).numpy()     # never the served storage

    # -- admission ----------------------------------------------------------
    def submit(self, u: int, candidates: Optional[Iterable[int]] = None, *,
               k: Optional[int] = None, deadline_s: Any = _UNSET) -> Optional[int]:
        """Admit one query (returns its qid) or shed it (returns None).

        Shedding happens only at admission: an admitted query is always
        answered (fresh or stale). No version at all, a full queue (or the
        ``queue_overflow`` drill), or a predicted wait that blows the
        deadline all reject at the door.
        """
        if deadline_s is _UNSET:
            deadline_s = self.cfg.default_deadline_s
        now = self.clock()
        with self._lock:
            if self._active is None:
                return self._shed("no_version")
            if self.faults.inject("queue_overflow") \
                    or len(self._queue) >= self.cfg.max_queue:
                return self._shed("overflow")
            if deadline_s is not None and self._wave_ema is not None:
                waves_ahead = len(self._queue) // self.cfg.batch_slots + 1
                predicted = waves_ahead * self._wave_ema * self.cfg.headroom
                if predicted > deadline_s:
                    return self._shed("deadline")
            qid = self._next_qid
            self._next_qid += 1
            q = Query(qid=qid, u=int(u),
                      candidates=(None if candidates is None
                                  else np.asarray(candidates, np.int32)),
                      k=int(k or 0), deadline_s=deadline_s, submit_t=now)
            self._queue.append(q)
            self.admitted += 1
        obs.inc("serve.admitted")
        return qid

    def _shed(self, reason: str) -> None:
        """(lock held) Count one shed admission."""
        self.shed[reason] = self.shed.get(reason, 0) + 1
        obs.inc(f"serve.shed.{reason}")
        return None

    # -- the serving loop ---------------------------------------------------
    def tick(self) -> List[Response]:
        """Score one wave from the queue on the snapshot captured at wave
        formation. On a wave fault the wave is re-queued at the front and
        the failure propagates: admitted queries survive the crash."""
        with self._lock:
            if not self._queue:
                return []
            take = min(len(self._queue), max(self.cfg.batch_slots, 1))
            wave = [self._queue.popleft() for _ in range(take)]
            snap = self._active
            freshness = self._freshness_locked()
        t0 = self.clock()
        try:
            self.faults.fire("serve_wave", note=len(wave))
            with obs.trace_span("serve.wave", size=len(wave), version=snap.version):
                scored = self._score_wave(wave, snap)
        except Exception:
            with self._lock:
                self._queue.extendleft(reversed(wave))
            self.wave_faults += 1
            obs.inc("serve.wave_faults")
            raise
        now = self.clock()
        wall = now - t0
        with self._lock:
            b = self.cfg.ema_beta
            self._wave_ema = wall if self._wave_ema is None else b * self._wave_ema + (1 - b) * wall
        out = []
        for q, (ids, scores) in zip(wave, scored):
            resp = Response(
                qid=q.qid, u=q.u, ids=ids, scores=scores,
                served_version=snap.version, served_graph_version=snap.graph_version,
                staleness_s=max(now - snap.created_t, 0.0),
                freshness=freshness, latency_s=now - q.submit_t)
            self.responses[q.qid] = resp
            out.append(resp)
            self.served += 1
            self.served_by_version[snap.version] = self.served_by_version.get(snap.version, 0) + 1
            self.served_by_freshness[freshness] += 1
            self._latency.observe(resp.latency_s)
        obs.inc("serve.responses", len(out))
        obs.set_gauge("serve.staleness_s", max(now - snap.created_t, 0.0))
        return out

    def _freshness_locked(self) -> str:
        return "fresh" if self.refresh_state == "ok" and not self._newer_pending else "stale"

    def _score_wave(self, wave: List[Query], snap: EmbedSnapshot) -> list:
        """Batched scoring of one wave on the snapshot's device. Top-K
        queries group by k (one scoring launch each), pair queries by a
        padded candidate bucket (powers of two, padded with id 0; one launch
        each); per-query slices are trimmed before the response."""
        results: Dict[int, tuple] = {}
        topk_groups: Dict[int, List[Query]] = {}
        cand_groups: Dict[int, List[Query]] = {}
        for q in wave:
            if q.candidates is None:
                topk_groups.setdefault(q.k, []).append(q)
            else:
                width = max(1, 1 << (len(q.candidates) - 1).bit_length()) \
                    if len(q.candidates) else 1
                cand_groups.setdefault(width, []).append(q)
        dev = snap.phi.device
        for k, group in topk_groups.items():
            u = torch.tensor([q.u for q in group], dtype=torch.int64, device=dev)
            vals, ids = _topk(snap.phi, u, k)
            vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
            for i, q in enumerate(group):
                results[q.qid] = (ids[i], vals[i])
        for width, group in cand_groups.items():
            cand = np.zeros((len(group), width), np.int32)
            for i, q in enumerate(group):
                cand[i, :len(q.candidates)] = q.candidates
            u = torch.tensor([q.u for q in group], dtype=torch.int64, device=dev)
            scores = _pair_scores(snap.phi, u, torch.from_numpy(cand).to(dev)).cpu().numpy()
            for i, q in enumerate(group):
                results[q.qid] = (np.asarray(q.candidates), scores[i, :len(q.candidates)])
        return [results[q.qid] for q in wave]

    def drain(self) -> List[Response]:
        """Tick until the queue is empty; responses in completion order."""
        out: List[Response] = []
        while True:
            batch = self.tick()
            if not batch:
                return out
            out.extend(batch)

    def serve(self, queries: List[Dict[str, Any]]) -> List[Optional[Response]]:
        """Submit a list of ``{"u", "candidates"|"k", ...}`` dicts, drain,
        and return responses aligned to the input order (``None`` where
        admission shed the query)."""
        qids = [self.submit(spec["u"], spec.get("candidates"), k=spec.get("k"),
                            deadline_s=spec.get("deadline_s", _UNSET))
                for spec in queries]
        self.drain()
        return [None if qid is None else self.responses.get(qid) for qid in qids]

    # -- accounting ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            depth = len(self._queue)
            active = self._active
            freshness = self._freshness_locked()
        shed_total = sum(self.shed.values())
        return {
            "admitted": self.admitted,
            "served": self.served,
            "shed": dict(self.shed),
            "shed_total": shed_total,
            "offered_total": self.admitted + shed_total,
            "availability": self.served / max(self.admitted, 1),
            "swaps": self.swaps,
            "rejected_candidates": self.rejected_candidates,
            "wave_faults": self.wave_faults,
            "queue_depth": depth,
            "active_version": None if active is None else active.version,
            "refresh_state": self.refresh_state,
            "freshness": freshness,
            "served_by_version": dict(self.served_by_version),
            "served_by_freshness": dict(self.served_by_freshness),
            "latency_p50_s": self._latency.percentile(50),
            "latency_p99_s": self._latency.percentile(99),
        }
