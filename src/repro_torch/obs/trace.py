"""Span tracer: nested, contextvar-scoped phase timing.

``with trace_span("walk.round", round=r):`` opens a span; on close its
wall time lands in the ``span.walk.round.s`` histogram, the closed-span
record is appended to the flight recorder ring and the JSONL event
stream, and — because the span body runs inside
``common.logging.log_context(**fields)`` — every log line emitted inside
the span carries the span's fields. Spans nest: a child records its
parent's name, and ``current_span()`` exposes the innermost frame so
point events (``span_event``) can attach to it.

Thread isolation comes free from the contextvar: a prefetch thread
starts with an empty span stack and cannot corrupt the driver thread's
nesting (``tests/test_torch_obs.py``).

The tracer is host-side only and time-based only — it never touches
device values, so it cannot perturb the computation. With
telemetry disabled ``trace_span`` short-circuits to a bare ``yield``
(one flag check, no clock reads, no contextvar writes).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.common.logging import current_context_fields, get_logger, \
    log_context
from repro_torch.obs import config as _config
from repro_torch.obs import metrics as _metrics

_log = get_logger("repro_torch.obs")

_SPAN_STACK: contextvars.ContextVar[Tuple[Dict[str, Any], ...]] = (
    contextvars.ContextVar("repro_span_stack", default=()))

#: Monotonically-increasing span id (uniqueness only; no ordering claims
#: across threads).
_NEXT_ID = [0]


def current_span() -> Optional[Dict[str, Any]]:
    """The innermost open span frame in this thread/context, or None."""
    stack = _SPAN_STACK.get()
    return stack[-1] if stack else None


def span_stack() -> Tuple[Dict[str, Any], ...]:
    """The full open-span stack (outermost first)."""
    return _SPAN_STACK.get()


def ambient_fields() -> Dict[str, Any]:
    """Merged fields of every open span, outer→inner (inner wins).

    This is what the flight recorder stamps onto point events so a
    fault fired deep inside ``refresh.splice`` still carries the round
    and graph_version of the enclosing spans.
    """
    fields: Dict[str, Any] = {}
    for frame in _SPAN_STACK.get():
        fields.update(frame["fields"])
    return fields


@contextlib.contextmanager
def trace_span(name: str, **fields: Any) -> Iterator[Optional[Dict[str, Any]]]:
    """Open a named span around the body.

    On exit (normal or exceptional) the closed-span record goes to the
    flight recorder and the JSONL stream, and the duration is recorded
    in the ``span.<name>.s`` histogram. An exception marks the record
    ``ok=False`` with the error type, then propagates.
    """
    if not _config.enabled():
        yield None
        return
    _NEXT_ID[0] += 1
    stack = _SPAN_STACK.get()
    frame: Dict[str, Any] = {
        "kind": "span",
        "id": _NEXT_ID[0],
        "name": name,
        "parent": stack[-1]["name"] if stack else None,
        "fields": dict(fields),
        "t_start": time.time(),
        "depth": len(stack),
    }
    token = _SPAN_STACK.set(stack + (frame,))
    t0 = time.perf_counter()
    try:
        with log_context(**fields):
            yield frame
        frame["ok"] = True
    except BaseException as e:
        frame["ok"] = False
        frame["error"] = type(e).__name__
        raise
    finally:
        frame["wall_s"] = time.perf_counter() - t0
        _SPAN_STACK.reset(token)
        _metrics.observe(f"span.{name}.s", frame["wall_s"])
        from repro_torch.obs import recorder as _recorder
        _recorder.record(frame)
        # Spans share the structured-log formatter: the close line runs
        # inside the span's own log_context so it carries the fields.
        if _log.isEnabledFor(10):  # logging.DEBUG
            with log_context(**fields):
                _log.debug("span %s wall=%.6fs ok=%s", name,
                           frame["wall_s"], frame.get("ok"))


def span_event(name: str, **fields: Any) -> None:
    """Record a point event (no duration) attached to the current span.

    Events land in the flight recorder and JSONL stream stamped with the
    merged fields of every enclosing span AND the ambient ``log_context``
    frames, so ``span_event("heal", reason=...)`` inside ``walk.round``
    carries the round for free — and a ``log_context(shard=...)`` block
    (no span) still stamps the shard.
    """
    if not _config.enabled():
        return
    record = {
        "kind": "event",
        "name": name,
        "t": time.time(),
        "fields": {**current_context_fields(), **ambient_fields(),
                   **fields},
        "span": (current_span() or {}).get("name"),
    }
    from repro_torch.obs import recorder as _recorder
    _recorder.record(record)
