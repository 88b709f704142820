"""Continuous ingest of edge churn: WAL -> apply -> refresh -> snapshot (the
JAX package's ``runtime/ingest.py``, ported).

The durability protocol of one churn batch:

    append   — the ``EdgeBatch`` is written to a write-ahead log record
               (length + CRC32 framed) and fsynced before the driver
               acknowledges it: an accepted batch can be re-applied, never
               lost;
    apply    — the batch is staged into the ``DeltaCSR`` overlay;
    refresh  — the incremental refresh absorbs the staged churn (subset
               re-walk, in-place fine-tune through the pipeline's CUDA
               graphs), retried with exponential backoff; each retry first
               restores the pipeline from the last snapshot, so a
               half-applied refresh is never retried on top of itself;
    snapshot — the pipeline checkpoints (atomic, fsynced) with the WAL
               sequence number it now covers (``applied_seq``);
    truncate — records at or below ``applied_seq`` are dropped (atomic
               rewrite): the log holds only churn the snapshot does not.

``IngestDriver.recover`` inverts it after a crash: resume the newest valid
snapshot, replay the WAL past its ``applied_seq`` (a torn last record, the
crash mid-append, fails its CRC and is dropped) and absorb it. The refresh
walks under the original round keys and fine-tunes under step-keyed RNG,
so the recovered state is bit-identical to a run that never crashed.

Bounded staleness: ``staleness()`` reports appended against applied
sequence numbers and the pending churn; ``IngestConfig.max_pending_edges``
turns the bound into backpressure (a submit past it drains at once).
``IngestConfig.staleness_slo_s`` is a per-batch submit -> applied deadline:
each drain picks the cheapest refresh mode that its per-mode wall EMA
(with headroom) fits into the oldest pending batch's remaining budget,
``full`` -> ``no_finetune`` (exact walks, phi lags) -> ``detect_only``
(the graph adopted, the affected roots kept as debt that the next full or
no_finetune drain walks again). ``submit`` validates a batch
(``graph.delta.validate_edge_batch``) before the WAL append, so a malformed
batch is refused at the door and never replayed.

The record layout and its npz payload are the reference's byte for byte:
each package replays the log the other wrote. A retry restores the
pipeline in place (``StreamingEmbedPipeline._restore_in_place``: phi and
the ring are copied into their own storage, so the captured CUDA graphs
stay valid and the device never holds a second pipeline), where the
reference builds a new pipeline by ``resume``.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.ckpt.checkpoint import read_meta
from repro_torch.common.logging import get_logger, log_context
from repro_torch.graph.delta import EdgeBatch, graph_version, validate_edge_batch
from repro_torch.runtime.faults import NULL_INJECTOR, FaultInjector, SimulatedFailure

log = get_logger("repro_torch.runtime.ingest")

_HEADER = struct.Struct("<QII")          # (seq, payload length, CRC32 of the payload)


def _encode_batch(batch: EdgeBatch) -> bytes:
    buf = io.BytesIO()
    arrays = {"insert": batch.insert, "delete": batch.delete}
    if batch.insert_weights is not None:
        arrays["insert_weights"] = batch.insert_weights
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_batch(payload: bytes) -> EdgeBatch:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return EdgeBatch(insert=z["insert"], delete=z["delete"],
                         insert_weights=z["insert_weights"] if "insert_weights" in z.files
                         else None)


def _record(seq: int, batch: EdgeBatch) -> bytes:
    payload = _encode_batch(batch)
    return _HEADER.pack(seq, len(payload), zlib.crc32(payload)) + payload


class WriteAheadLog:
    """Append-only, CRC-framed log of churn batches, fsynced on append.

    A record is a ``<QII`` header (monotonic seq, payload length, CRC32 of
    the payload) and the payload (an npz of the batch's arrays). ``replay``
    stops at the first torn record: a short header, a short payload or a
    CRC mismatch means the crash landed mid-append, and everything from
    there on is garbage (records are written in order and fsynced before
    they are acknowledged). ``last_append`` holds the newest append's
    bytes and its write and fsync seconds."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.last_append: Optional[Dict[str, float]] = None

    def append(self, seq: int, batch: EdgeBatch,
               faults: FaultInjector = NULL_INJECTOR) -> int:
        record = _record(seq, batch)
        if faults.torn("wal"):
            # A crash mid-append: only a prefix of the record reaches the disk.
            with open(self.path, "ab") as f:
                f.write(record[:max(1, len(record) // 2)])
                f.flush()
                os.fsync(f.fileno())
            raise SimulatedFailure(f"torn WAL append at seq {seq}")
        with obs.trace_span("ingest.wal_append", seq=seq, bytes=len(record)):
            t0 = time.perf_counter()
            with open(self.path, "ab") as f:
                f.write(record)
                f.flush()
                t1 = time.perf_counter()
                os.fsync(f.fileno())
            t2 = time.perf_counter()
        self.last_append = {"bytes": len(record), "write_s": t1 - t0, "fsync_s": t2 - t1}
        obs.inc("ingest.wal_bytes", len(record))
        return seq

    def replay(self, after_seq: int = 0) -> Tuple[List[Tuple[int, EdgeBatch]], int]:
        """(records with seq > ``after_seq``, bytes of the valid prefix). A
        torn tail is reported and left out."""
        if not os.path.exists(self.path):
            return [], 0
        with open(self.path, "rb") as f:
            data = f.read()
        records, off = [], 0
        while off + _HEADER.size <= len(data):
            seq, length, crc = _HEADER.unpack_from(data, off)
            body = data[off + _HEADER.size: off + _HEADER.size + length]
            if len(body) < length or zlib.crc32(body) != crc:
                log.warning("WAL %s: torn record at offset %d (seq %d): discarding the tail",
                            self.path, off, seq)
                break
            if seq > after_seq:
                records.append((seq, _decode_batch(body)))
            off += _HEADER.size + length
        else:
            if off < len(data):
                log.warning("WAL %s: %d trailing bytes (a torn header): discarding",
                            self.path, len(data) - off)
        return records, off

    def truncate_upto(self, applied_seq: int) -> None:
        """Drop the records with seq <= ``applied_seq`` (and any torn tail),
        atomically: the steady state truncates to an empty log."""
        keep, _ = self.replay(after_seq=applied_seq)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for seq, batch in keep:
                f.write(_record(seq, batch))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        dir_fd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)


@dataclasses.dataclass
class IngestConfig:
    apply_every: int = 1            # WAL batches per refresh
    max_pending_edges: Optional[int] = None   # the staleness bound (backpressure)
    max_retries: int = 3            # refresh retries (after a restore) per drain
    backoff_s: float = 0.05         # exponential: backoff_s * 2**attempt
    snapshot_dir: str = "snapshots"
    wal_name: str = "wal.log"
    # Admission control, before the WAL append.
    validate: bool = True
    self_loop_policy: str = "drop"        # "drop" | "forbid" | "allow"
    duplicate_policy: str = "allow"       # the same, for duplicates within a batch
    # The staleness SLO and its degrade ladder.
    staleness_slo_s: Optional[float] = None   # submit -> applied deadline
    slo_headroom: float = 1.5       # a mode fits if its EMA * headroom <= the budget
    latency_window: int = 64        # submit -> applied percentile history


class IngestDriver:
    """The churn driver around one ``StreamingEmbedPipeline``.

    ``submit`` makes a batch durable in the WAL at once and absorbs the
    pending batches (apply -> refresh -> snapshot -> truncate) every
    ``apply_every`` batches, sooner when ``max_pending_edges`` trips, or on
    ``drain()``. ``recover`` rebuilds a driver after a process death from
    the snapshot and the WAL alone. ``server`` (duck-typed: ``note_refresh``
    and ``offer_snapshot``) is told of each drain's outcome and offered each
    snapshot."""

    def __init__(self, root: str, pipeline, *, detect: str = "traversal",
                 cfg: IngestConfig = IngestConfig(),
                 refresh_kwargs: Optional[Dict[str, Any]] = None,
                 faults: FaultInjector = NULL_INJECTOR,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 server: Optional[Any] = None,
                 _initial_snapshot: bool = True):
        from repro_torch.core.incremental import IncrementalRefresh

        self.root = root
        self.cfg = cfg
        self.detect = detect
        self.refresh_kwargs = dict(refresh_kwargs or {})
        self.faults = faults
        self.sleep = sleep
        self.clock = clock
        self.server = server
        self.pipeline = pipeline
        self.refresher = IncrementalRefresh(pipeline, detect=detect)
        self.ckpt_dir = os.path.join(root, cfg.snapshot_dir)
        self.wal = WriteAheadLog(os.path.join(root, cfg.wal_name))
        self.applied_seq = 0
        self.appended_seq = 0
        self._pending: List[Tuple[int, EdgeBatch]] = []
        self.drains = 0
        self.retries = 0
        # The degrade ladder's state. One bounded histogram serves both
        # staleness()'s percentiles and the exported ingest.latency_s; the
        # driver owns it (a new driver starts empty) and the registry
        # exports it.
        self._submit_t: Dict[int, float] = {}
        self._latency = obs.Histogram(window=max(cfg.latency_window, 1))
        obs.REGISTRY.attach("ingest.latency_s", self._latency)
        self._wall_ema: Dict[str, float] = {}
        self.mode_counts = {"full": 0, "no_finetune": 0, "detect_only": 0}
        self.last_mode: Optional[str] = None
        self.slo_violations = 0
        self._debt: Optional[np.ndarray] = None   # affected roots a detect-only drain deferred
        if _initial_snapshot:
            # The recovery base: the WAL never holds churn without a
            # snapshot to replay it against.
            self._snapshot()
            self._publish()

    # --- ingress -------------------------------------------------------------
    def submit(self, batch: EdgeBatch) -> int:
        """Accept one churn batch durably, and absorb when the cadence or the
        staleness bound says so. Returns its WAL sequence number. A batch
        refused by validation raises ``ValueError`` and leaves no trace:
        neither the log nor the sequence moves."""
        if self.cfg.validate:
            batch = validate_edge_batch(batch, self.pipeline.graph.num_nodes,
                                        self_loops=self.cfg.self_loop_policy,
                                        duplicates=self.cfg.duplicate_policy)
        seq = self.appended_seq + 1
        with obs.trace_span("ingest.submit", seq=seq, graph_version=self._graph_version()):
            self.wal.append(seq, batch, faults=self.faults)
            self.appended_seq = seq
            self._pending.append((seq, batch))
            self._submit_t[seq] = self.clock()
            self.faults.fire("wal_append", seq)
        over = (self.cfg.max_pending_edges is not None
                and self.pending_edges() > self.cfg.max_pending_edges)
        if len(self._pending) >= self.cfg.apply_every or over:
            self.drain()
        return seq

    def pending_edges(self) -> int:
        return sum(b.num_changes for _, b in self._pending)

    def staleness(self) -> Dict[str, Any]:
        """How far the embedding lags the accepted churn: the sequence lag,
        the submit -> applied latency percentiles, the oldest pending
        batch's age against the SLO, the modes chosen and the debt."""
        pct = {f"latency_p{q}_s": self._latency.percentile(q) for q in (50, 90, 99)}
        oldest = self._submit_t.get(self._pending[0][0]) if self._pending else None
        return {
            "appended_seq": self.appended_seq,
            "applied_seq": self.applied_seq,
            "pending_batches": len(self._pending),
            "pending_edges": self.pending_edges(),
            "max_pending_edges": self.cfg.max_pending_edges,
            "graph_version": self._graph_version(),
            "drains": self.drains,
            "retries": self.retries,
            **pct,
            "oldest_pending_age_s": self.clock() - oldest if oldest is not None else None,
            "staleness_slo_s": self.cfg.staleness_slo_s,
            "slo_violations": self.slo_violations,
            "last_mode": self.last_mode,
            "mode_counts": dict(self.mode_counts),
            "debt_roots": int(self._debt.sum()) if self._debt is not None else 0,
            "wall_ema_s": dict(self._wall_ema),
        }

    def _graph_version(self) -> int:
        return int(graph_version(self.pipeline.graph))

    # --- absorption ------------------------------------------------------------
    def _choose_mode(self) -> str:
        """The cheapest mode whose wall EMA, with headroom, fits the oldest
        pending batch's remaining budget. No SLO: always full. A mode never
        run has no EMA and is assumed to fit; a blown budget goes straight
        to detect_only (the deadline is lost: spend the least)."""
        cfg = self.cfg
        if cfg.staleness_slo_s is None or not self._pending:
            return "full"
        oldest = self._submit_t.get(self._pending[0][0])
        if oldest is None:                      # a recovered batch has no clock
            return "full"
        budget = cfg.staleness_slo_s - (self.clock() - oldest)
        if budget <= 0:
            return "detect_only"
        for mode in ("full", "no_finetune", "detect_only"):
            ema = self._wall_ema.get(mode)
            if ema is None or ema * cfg.slo_headroom <= budget:
                return mode
        return "detect_only"

    def drain(self) -> Optional[Any]:
        """Absorb every pending batch: apply -> refresh (retried, the
        snapshot restored between attempts) -> snapshot -> truncate, at the
        mode the SLO budget allows. A detect-only drain banks its affected
        roots as debt; the next drain of another mode pays it
        (``extra_affected``). Returns the refresh's ``RefreshStats``."""
        if not self._pending:
            return None
        batches = list(self._pending)
        last_seq = batches[-1][0]
        mode = self._choose_mode()
        with log_context(applied_seq=self.applied_seq, target_seq=last_seq,
                         graph_version=self._graph_version(), mode=mode), \
                obs.trace_span("ingest.drain", applied_seq=self.applied_seq,
                               target_seq=last_seq, mode=mode):
            stats = self._apply_with_retry(batches, mode)
            self.applied_seq = last_seq
            self._pending = []
            self._snapshot()
            self.wal.truncate_upto(self.applied_seq)
            if self.server is not None:
                self.server.note_refresh("ok")
            self._publish()
            self.drains += 1
            now = self.clock()
            for seq, _ in batches:
                t = self._submit_t.pop(seq, None)
                if t is None:
                    continue
                self._latency.observe(now - t)
                if self.cfg.staleness_slo_s is not None and now - t > self.cfg.staleness_slo_s:
                    self.slo_violations += 1
                    obs.inc("ingest.slo_violations")
            self.mode_counts[mode] += 1
            self.last_mode = mode
            obs.inc("ingest.drains")
            obs.inc(f"ingest.mode.{mode}")
            obs.set_gauge("ingest.applied_seq", self.applied_seq)
            obs.set_gauge("ingest.graph_version", self._graph_version())
            wall = float(getattr(stats, "wall_s", 0.0))
            obs.observe("ingest.refresh.s", wall)
            prev = self._wall_ema.get(mode)
            self._wall_ema[mode] = wall if prev is None else 0.5 * prev + 0.5 * wall
            if mode == "detect_only":
                m = np.asarray(self.refresher.last_affected_mask, bool)
                self._debt = m.copy() if self._debt is None else (self._debt | m)
            else:
                self._debt = None               # paid through extra_affected
            log.info("drained %d batches (%d edges) in %s refresh: affected=%s wall=%.3fs",
                     len(batches), sum(b.num_changes for _, b in batches), mode,
                     getattr(stats, "affected", "?"), getattr(stats, "wall_s", float("nan")))
        return stats

    def _apply_with_retry(self, batches, mode: str = "full") -> Any:
        cfg = self.cfg
        extra = self._debt if mode != "detect_only" else None
        for attempt in range(cfg.max_retries + 1):
            try:
                for _, b in batches:
                    self.refresher.apply_updates(b)
                return self.refresher.refresh(faults=self.faults, mode=mode,
                                              extra_affected=extra, **self.refresh_kwargs)
            except Exception as e:
                # A failed refresh may have spliced part of the ring and
                # mutated the overlay: restore the pre-churn snapshot before
                # a retry, so the batch never lands on its own wreckage. A
                # server moves to its stale-ok rung meanwhile.
                obs.span_event("ingest.retry", attempt=attempt, error=type(e).__name__)
                if self.server is not None:
                    self.server.note_refresh("degraded")
                self._restore_last_snapshot()
                if attempt >= cfg.max_retries:
                    if self.server is not None:
                        self.server.note_refresh("failed")
                    obs.dump_flight_record("ingest_retries_exhausted", attempt=attempt,
                                           error=type(e).__name__, mode=mode)
                    raise
                self.retries += 1
                obs.inc("ingest.retries")
                delay = cfg.backoff_s * (2 ** attempt)
                log.warning("refresh attempt %d failed (%s: %s); restored the snapshot, "
                            "backing off %.3fs", attempt, type(e).__name__, e, delay)
                self.sleep(delay)

    def _snapshot(self) -> None:
        self.pipeline.save(self.ckpt_dir, faults=self.faults,
                           meta_extra={"applied_seq": int(self.applied_seq), "ingest": True})

    def _publish(self) -> None:
        """Offer the newest snapshot to the server. A serve-side failure (a
        torn candidate, a gate's refusal) never stops ingest: the server
        keeps its version and the next snapshot is offered again."""
        if self.server is None:
            return
        try:
            self.server.offer_snapshot(self.ckpt_dir)
        except Exception as e:
            obs.inc("ingest.publish_failed")
            log.warning("snapshot publish failed (%s: %s); the server keeps its active "
                        "version", type(e).__name__, e)

    def _restore_last_snapshot(self) -> None:
        """Back to the newest snapshot, in the pipeline's own storage, and a
        new overlay over its graph."""
        from repro_torch.core.incremental import IncrementalRefresh

        self.pipeline._restore_in_place(self.ckpt_dir)
        self.refresher = IncrementalRefresh(self.pipeline, detect=self.detect)

    # --- crash recovery ------------------------------------------------------------
    @classmethod
    def recover(cls, root: str, policy, spec, dsgl_cfg, *, detect: str = "traversal",
                cfg: IngestConfig = IngestConfig(),
                refresh_kwargs: Optional[Dict[str, Any]] = None,
                faults: FaultInjector = NULL_INJECTOR,
                sleep: Callable[[float], None] = time.sleep,
                clock: Callable[[], float] = time.monotonic,
                server: Optional[Any] = None, device="cuda") -> "IngestDriver":
        """Rebuild a driver after a crash from the newest valid snapshot and
        the WAL's tail, on ``device``. Every durable but unapplied batch is
        absorbed through the normal path, so the recovered driver ends where
        the crashed one was headed, whether it died mid-refresh,
        mid-snapshot (the torn snapshot is skipped) or mid-append (the torn
        record is dropped: that batch was never acknowledged)."""
        from repro_torch.runtime.trainer import StreamingEmbedPipeline

        ckpt_dir = os.path.join(root, cfg.snapshot_dir)
        step, meta = read_meta(ckpt_dir)
        pipeline = StreamingEmbedPipeline.resume(ckpt_dir, policy, spec, dsgl_cfg, step=step,
                                                 device=device)
        driver = cls(root, pipeline, detect=detect, cfg=cfg, refresh_kwargs=refresh_kwargs,
                     faults=faults, sleep=sleep, clock=clock, server=server,
                     _initial_snapshot=False)
        driver.applied_seq = int(meta.get("applied_seq", 0))
        tail, _ = driver.wal.replay(after_seq=driver.applied_seq)
        driver.appended_seq = tail[-1][0] if tail else driver.applied_seq
        with log_context(applied_seq=driver.applied_seq, wal_tail=len(tail)):
            log.info("recovering the ingest driver from snapshot %d and %d WAL tail batches",
                     step, len(tail))
        if tail:
            driver._pending = tail
            driver.drain()
        else:
            driver.wal.truncate_upto(driver.applied_seq)     # drop any torn tail bytes
            driver._publish()
        return driver

    def embeddings(self):
        return self.pipeline.embeddings()
