"""Fault-injection harness for the walk→train lifecycle (the JAX
package's ``runtime/faults.py``, copied).

The LM trainer shipped a step-granular ``FailureInjector``; this module
generalizes it into named **injection points** threaded through the whole
embedding pipeline so recovery invariants can be exercised at every host
boundary where a real crash can land:

    ``superstep``   — once per ``walker_batch`` sources of a round, before
                      its walks commit (a crash mid-round: some walks
                      computed, none committed);
    ``round``       — at the top of a round iteration (after the ΔD
                      decision, before training);
    ``tail``        — between schedule-tail training iterations;
    ``refresh``     — at refresh entry (churn staged, nothing spliced);
    ``refresh_splice`` — between per-round ``ring_replace`` splices inside
                      a refresh (the half-updated-ring hazard);
    ``ckpt_write``  — immediately before a snapshot commits (the snapshot
                      is lost; recovery must fall back one snapshot);
    ``wal_append``  — after a WAL record is durable but before it applies
                      (``runtime.ingest.IngestDriver.submit``).

Each point carries a cumulative occurrence counter (monotonic across
supervisor restarts — the same injector object rides through the restart
loop), and a plan maps point → occurrence indices at which to raise
``SimulatedFailure``. Every planned occurrence fires at most once, which is
exactly the "crash once, then the retry succeeds" shape a restart test
needs.

Torn-write simulation: ``torn("ckpt")`` / ``torn("wal")`` report whether
the *current* occurrence should leave a torn artifact behind (half a WAL
record, a committed checkpoint directory with a corrupt manifest) before
raising — the writer cooperates by truncating its own output. This models
a crash midway through the physical write, the case the fsync-before-
rename and WAL-checksum protocols exist for.

Silent-corruption simulation: ``inject(kind)`` is the non-crashing sibling
of ``torn`` — it reports whether the current occurrence of a *corruption
site* should poison its data instead of raising. The pipeline's training
loop consults ``inject("phi_nan")`` (overwrite embedding rows with NaN —
a flipped bit / bad DMA) and ``inject("lr_spike")`` (multiply the chunk's
learning rates — a scheduler bug / optimizer blow-up) so the health
watchdog's divergence → rollback → backoff path can be exercised against
*real* divergences, not mocked verdicts.

Liveness simulation: ``probe_ok(shard)`` answers a liveness probe for one
walk shard; ``down_plan`` maps shard id → probe occurrence from which the
shard stops answering FOREVER (persistent loss — a dead machine, not a
transient timeout). ``LivenessProbe`` turns consecutive missed probes into
a dead-shard declaration the pipeline reacts to with elastic
reconfiguration.

``run_with_restarts`` is the generic supervisor loop a cluster agent would
drive: attempt → on ``SimulatedFailure`` recover from durable state →
re-attempt, bounded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

from repro_torch import obs


class SimulatedFailure(RuntimeError):
    """Stands in for a node crash / preemption."""


#: Canonical pipeline injection points (tests sweep these).
PIPELINE_POINTS = ("superstep", "round", "tail", "ckpt_write")
INGEST_POINTS = ("wal_append", "refresh", "refresh_splice")
#: Serve-side injection points (the embedding server's): ``swap`` fires inside the
#: snapshot-swap window (before the commit — the active version must stay
#: serving), ``serve_wave`` between admission and wave scoring. The
#: ``queue_overflow`` corruption site (via ``inject``) forces admission to
#: behave as if the queue were full — a shed drill without real load.
SERVE_POINTS = ("swap", "serve_wave")


@dataclasses.dataclass
class FaultInjector:
    """Raise ``SimulatedFailure`` at planned (point, occurrence) pairs.

    plan:  {"round": (1,), "wal_append": (0,)} — fail the 2nd time the
           ``round`` point is reached and the 1st ``wal_append``.
    torn_plan: occurrences at which the failure should additionally leave
           a torn artifact ({"ckpt": (0,), "wal": (0,)}); consumed by the
           writer via ``torn(kind)`` *before* the matching ``fire``.
    inject_plan: occurrences at which a corruption site should poison its
           data in place of crashing ({"phi_nan": (2,)}); consumed via
           ``inject(kind)`` — no exception is raised, the corruption is
           expected to be CAUGHT downstream (by the health watchdog).
    down_plan: {shard_id: probe_occurrence} — the shard stops answering
           liveness probes from that occurrence on (persistent loss). A
           ``(start, stop)`` tuple value makes the outage TRANSIENT: the
           shard misses probes for occurrences ``start <= i < stop`` and
           answers again afterwards (capacity returns — the re-JOIN drill).
    """

    plan: Mapping[str, Iterable[int]] = dataclasses.field(default_factory=dict)
    torn_plan: Mapping[str, Iterable[int]] = dataclasses.field(
        default_factory=dict)
    inject_plan: Mapping[str, Iterable[int]] = dataclasses.field(
        default_factory=dict)
    down_plan: Mapping[int, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._plan = {p: set(occ) for p, occ in dict(self.plan).items()}
        self._torn = {p: set(occ) for p, occ in dict(self.torn_plan).items()}
        self._inject = {p: set(occ)
                        for p, occ in dict(self.inject_plan).items()}
        self._down = {}
        for s, t in dict(self.down_plan).items():
            if isinstance(t, (tuple, list)):
                start, stop = t
                self._down[int(s)] = (int(start), int(stop))
            else:
                self._down[int(s)] = int(t)
        self.counts: Dict[str, int] = {}
        self.fired: list = []          # [(point, occurrence), ...]
        self.injected: list = []       # [(kind, occurrence), ...]

    def fire(self, point: str, note: Any = None) -> None:
        """Count one occurrence of ``point``; raise if the plan says so."""
        i = self.counts.get(point, 0)
        self.counts[point] = i + 1
        planned = self._plan.get(point)
        if planned and i in planned:
            planned.discard(i)         # fire at most once per occurrence
            self.fired.append((point, i))
            # Postmortem first, crash second: the dump carries the open
            # spans (round/shard/graph_version) of the site that died.
            obs.span_event("fault.fire", point=point, occurrence=i,
                           note=note)
            obs.inc(f"faults.fired.{point}")
            obs.dump_flight_record(f"fault_{point}", point=point,
                                   occurrence=i, note=note)
            raise SimulatedFailure(
                f"injected failure at {point}[{i}]"
                + (f" ({note})" if note is not None else ""))

    def torn(self, kind: str) -> bool:
        """Should the current write of ``kind`` be left torn? (Consumes the
        planned occurrence; the caller raises via ``fire`` afterwards.)"""
        i = self.counts.get(f"torn_{kind}", 0)
        self.counts[f"torn_{kind}"] = i + 1
        planned = self._torn.get(kind)
        if planned and i in planned:
            planned.discard(i)
            obs.span_event("fault.torn", kind=kind, occurrence=i)
            obs.inc(f"faults.torn.{kind}")
            return True
        return False

    def inject(self, kind: str) -> bool:
        """Should the current occurrence of corruption site ``kind`` poison
        its data? Counts the occurrence and consumes the planned one — like
        ``torn``, but no exception follows: the corruption is silent and
        must be *detected* by the layer under test."""
        i = self.counts.get(f"inject_{kind}", 0)
        self.counts[f"inject_{kind}"] = i + 1
        planned = self._inject.get(kind)
        if planned and i in planned:
            planned.discard(i)
            self.injected.append((kind, i))
            obs.span_event("fault.inject", kind=kind, occurrence=i)
            obs.inc(f"faults.injected.{kind}")
            return True
        return False

    def probe_ok(self, shard: int) -> bool:
        """Answer one liveness probe for ``shard`` (ids are the ORIGINAL
        launch-time shard names — they stay stable across elastic
        reconfigurations). A shard planned down at occurrence t misses
        every probe from its t-th on (persistent loss); a ``(start, stop)``
        plan misses only inside that occurrence window (transient outage —
        the machine comes back and may re-JOIN)."""
        i = self.counts.get(f"probe_{shard}", 0)
        self.counts[f"probe_{shard}"] = i + 1
        t = self._down.get(int(shard))
        if t is None:
            return True
        if isinstance(t, tuple):
            start, stop = t
            return not (start <= i < stop)
        return i < t

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._plan.values()) + sum(
            len(v) for v in self._torn.values()) + sum(
            len(v) for v in self._inject.values())


class NullInjector(FaultInjector):
    """Injector that never fires (the production default)."""

    def __init__(self):
        super().__init__(plan={}, torn_plan={})

    def fire(self, point: str, note: Any = None) -> None:  # noqa: D102
        pass

    def torn(self, kind: str) -> bool:                     # noqa: D102
        return False

    def inject(self, kind: str) -> bool:                   # noqa: D102
        return False

    def probe_ok(self, shard: int) -> bool:                # noqa: D102
        return True


NULL_INJECTOR = NullInjector()


@dataclasses.dataclass
class LivenessProbe:
    """Consecutive-miss liveness detector over the walk shards.

    Shards are tracked by their ORIGINAL launch-time ids (``names``) so an
    injector's ``down_plan`` stays meaningful across elastic
    reconfigurations that compact the dispatch id space. ``poll`` probes
    every still-tracked shard once and returns the CURRENT dispatch ids of
    shards that just crossed ``misses_to_dead`` consecutive misses —
    exactly the ids ``StreamingEmbedPipeline.elastic_reconfigure``
    expects. A successful probe resets the shard's miss counter, so a
    transient hiccup shorter than the threshold never triggers a (costly,
    irreversible) reconfiguration. After reacting, callers MUST call
    ``remove(dispatch_id)`` so the probe's id space tracks the compacted
    assignment.

    Removed shards keep being probed: ``hits_to_live`` consecutive
    *successful* probes of a dead name mark it rejoin-eligible
    (``rejoinable()``) — the symmetric hysteresis to ``misses_to_dead``,
    so one lucky probe of a flapping machine never triggers a (costly)
    k → k+1 re-JOIN. After growing back, callers MUST call
    ``rejoin(name)``; the shard re-enters the dispatch space at the END
    (matching ``mpgp.rejoin_shard``, which appends the returned shard).
    """

    num_shards: int
    misses_to_dead: int = 2
    hits_to_live: int = 2

    def __post_init__(self):
        self.names = list(range(self.num_shards))   # index = dispatch id
        self.misses = [0] * self.num_shards
        self.dead_names: list = []
        self.dead_hits: Dict[int, int] = {}         # name -> consecutive oks
        self.probes = 0

    def poll(self, faults: "FaultInjector" = NULL_INJECTOR) -> list:
        """One probe sweep; returns newly-dead shards as dispatch ids,
        in descending order (safe to reconfigure + ``remove`` one by one,
        ids below a removed one are untouched). Dead names are probed in
        the same sweep so rejoin eligibility accrues."""
        newly_dead = []
        self.probes += 1
        for i, name in enumerate(self.names):
            if faults.probe_ok(name):
                self.misses[i] = 0
                continue
            self.misses[i] += 1
            if self.misses[i] >= self.misses_to_dead:
                newly_dead.append(i)
        for name in self.dead_names:
            if faults.probe_ok(name):
                self.dead_hits[name] = self.dead_hits.get(name, 0) + 1
            else:
                self.dead_hits[name] = 0
        return sorted(newly_dead, reverse=True)

    def remove(self, dispatch_id: int) -> int:
        """Stop tracking a declared-dead shard; ids above it shift down by
        one (matching ``mpgp.compact_assignment``). Returns the shard's
        stable launch-time name."""
        name = self.names.pop(dispatch_id)
        self.misses.pop(dispatch_id)
        self.dead_names.append(name)
        self.dead_hits[name] = 0
        return name

    def rejoinable(self) -> list:
        """Dead names that answered ``hits_to_live`` consecutive probes —
        capacity is back and the pipeline may grow k → k+1."""
        return [n for n in self.dead_names
                if self.dead_hits.get(n, 0) >= self.hits_to_live]

    def rejoin(self, name: int) -> int:
        """Re-track a returned shard. It gets the HIGHEST dispatch id
        (appended), mirroring ``mpgp.rejoin_shard``'s id layout. Returns
        the new dispatch id."""
        self.dead_names.remove(name)
        self.dead_hits.pop(name, None)
        self.names.append(name)
        self.misses.append(0)
        return len(self.names) - 1


@dataclasses.dataclass
class FailureInjector:
    """Step-granular injector (the original LM-trainer interface, kept as
    the compatibility surface; ``FaultInjector`` is the generalized form)."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_restarts(
    attempt: Callable[[int], Any],
    *,
    recover: Optional[Callable[[int], None]] = None,
    max_restarts: int = 8,
) -> Tuple[Any, int]:
    """Supervisor loop: run ``attempt(restart_idx)``; on ``SimulatedFailure``
    call ``recover(restart_idx)`` (restore from durable state) and retry.

    Returns (result, restarts). Raises the last failure once
    ``max_restarts`` is exhausted — a supervisor must not loop forever on a
    deterministic crash.
    """
    restarts = 0
    while True:
        try:
            return attempt(restarts), restarts
        except SimulatedFailure as e:
            restarts += 1
            obs.span_event("supervisor.restart", restart=restarts,
                           error=str(e))
            obs.inc("supervisor.restarts")
            if restarts > max_restarts:
                obs.dump_flight_record("restarts_exhausted",
                                       restarts=restarts, error=str(e))
                raise
            if recover is not None:
                recover(restarts)
