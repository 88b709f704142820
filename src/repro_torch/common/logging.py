"""Tiny structured logger (stdlib logging, one-line setup).

``REPRO_LOG_LEVEL`` (DEBUG/INFO/WARNING/ERROR, or a number) sets the level
of the ``repro_torch`` loggers and is re-read on every ``get_logger``
call, so a test or operator can flip verbosity mid-process; the JAX
package reads the same variable for its own loggers. ``log_context(round=3,
shard=1)`` pushes structured fields that every log line emitted inside the
``with`` block carries as trailing ``key=value`` pairs: the pipeline wraps
its phases in it, so a postmortem greps a crash down to the round, shard or
graph_version without the call sites threading those fields by hand.
``obs.trace_span`` pushes its span fields through the same contextvar and
emits its close lines through the same handler, so spans and log lines
share one format.

The handler install is idempotent by inspection, not by module flag: the
handler installed here is tagged, and ``get_logger`` only adds one when no
tagged handler is present, so a re-import of this module cannot stack
duplicate handlers.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import sys

ROOT_LOGGER = "repro_torch"

_CONTEXT: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_log_context", default=())

#: Attribute marking the handler this module installs; idempotency is "a
#: tagged handler exists", which survives module re-imports.
_HANDLER_TAG = "_repro_torch_handler"

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s%(ctx)s"


class _ContextFilter(logging.Filter):
    """Append the active ``log_context`` fields to every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        fields = current_context_fields()
        record.ctx = (" [" + " ".join(f"{k}={v}" for k, v in fields.items()) + "]"
                      if fields else "")
        return True


def _env_level(default: int = logging.INFO) -> int:
    raw = os.environ.get("REPRO_LOG_LEVEL", "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    return getattr(logging, raw.upper(), default)


def _installed_handler(root: logging.Logger) -> logging.Handler | None:
    for h in root.handlers:
        if getattr(h, _HANDLER_TAG, False):
            return h
    return None


def refresh_log_level() -> int:
    """Re-read ``REPRO_LOG_LEVEL`` and apply it to the package's root
    logger; returns the applied level."""
    level = _env_level()
    logging.getLogger(ROOT_LOGGER).setLevel(level)
    return level


def get_logger(name: str = ROOT_LOGGER) -> logging.Logger:
    root = logging.getLogger(ROOT_LOGGER)
    if _installed_handler(root) is None:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_ContextFilter())
        setattr(handler, _HANDLER_TAG, True)
        root.addHandler(handler)
        root.propagate = False
    refresh_log_level()
    return logging.getLogger(name)


def current_context_fields() -> dict:
    """The merged ``log_context`` fields active in this thread / context
    (outer to inner, inner wins). ``obs`` stamps these onto point events
    and flight-recorder dumps, so a postmortem carries the same round,
    shard and graph_version the log lines do."""
    fields = {}
    for frame in _CONTEXT.get():
        fields.update(frame)
    return fields


@contextlib.contextmanager
def log_context(**fields):
    """Attach ``key=value`` fields to every log line in this block.

    Nested contexts merge (inner wins on a key collision); the contextvar
    scoping keeps prefetch and driver threads from seeing each other's
    frames."""
    token = _CONTEXT.set(_CONTEXT.get() + (fields,))
    try:
        yield
    finally:
        _CONTEXT.reset(token)
