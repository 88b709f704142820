"""Flight recorder: a bounded ring of recent spans/events, dumped to
disk when something dies.

Every closed span and point event is appended to a process-wide ring
(default 512 records — a few rounds of a streaming run). On failure —
``FaultInjector.fire``, a ``DivergenceError`` verdict, ``run_with_restarts``
exhausting its restarts — the failing layer calls
``dump_flight_record(reason, ...)`` which writes the ring, the metrics
snapshot, and the failure context to
``<flight_dir>/flight_<reason>_<seq>.json``: a self-contained postmortem
that replaces grepping raw logs.

Dumps only happen when a flight directory is configured
(``REPRO_FLIGHT_DIR`` or ``obs.configure(flight_dir=...)``) — the
fault-injection test suites exercise hundreds of deliberate crashes and
must not litter the working tree. The in-memory ring always runs (when
telemetry is enabled) so a late ``configure`` still captures history.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import config as _config
from repro_torch.obs import metrics as _metrics

DEFAULT_RING = 512

_LOCK = threading.Lock()
_RING: collections.deque = collections.deque(maxlen=DEFAULT_RING)
_DUMP_SEQ = [0]


def record(rec: Dict[str, Any]) -> None:
    """Append one span/event record to the ring and the JSONL stream."""
    if not _config.enabled():
        return
    with _LOCK:
        _RING.append(rec)
    _config.emit_jsonl(rec)


def recent(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The most recent records, oldest first."""
    with _LOCK:
        items = list(_RING)
    return items if n is None else items[-n:]


def clear() -> None:
    with _LOCK:
        _RING.clear()


def resize(capacity: int) -> None:
    """Resize the ring, keeping the most recent records."""
    global _RING
    with _LOCK:
        _RING = collections.deque(_RING, maxlen=max(int(capacity), 1))


def dump_flight_record(reason: str, **context: Any) -> Optional[str]:
    """Write the ring + metrics snapshot + failure context to disk.

    Returns the dump path, or ``None`` when no flight directory is
    configured / telemetry is off. Never raises: a postmortem writer
    that can itself crash the process is worse than no postmortem.
    """
    if not _config.enabled():
        return None
    flight_dir = _config.flight_dir()
    if not flight_dir:
        return None
    try:
        from repro_torch.common.logging import current_context_fields
        from repro_torch.obs import trace as _trace
        open_spans = [
            {"name": f["name"], "fields": f["fields"], "depth": f["depth"]}
            for f in _trace.span_stack()]
        # log_context frames include every open span's fields (trace_span
        # pushes through the same contextvar) plus bare log_context blocks.
        ambient = {**current_context_fields(), **_trace.ambient_fields()}
        with _LOCK:
            _DUMP_SEQ[0] += 1
            seq = _DUMP_SEQ[0]
            ring = list(_RING)
        dump = {
            "schema": "repro.flight_record.v1",
            "reason": reason,
            "t": time.time(),
            "context": {**ambient, **{k: v for k, v in context.items()
                                      if v is not None}},
            "open_spans": open_spans,
            "ring": ring,
            "metrics": _metrics.REGISTRY.snapshot(),
        }
        os.makedirs(flight_dir, exist_ok=True)
        safe = "".join(c if (c.isalnum() or c in "_-") else "_"
                       for c in reason)
        path = os.path.join(flight_dir, f"flight_{safe}_{seq:04d}.json")
        with open(path, "w") as f:
            json.dump(dump, f, indent=1, default=str)
        return path
    except Exception:
        return None


def load_flight_record(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
