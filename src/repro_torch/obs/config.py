"""Process-wide telemetry switchboard.

One mutable configuration shared by the registry, the tracer and the
flight recorder, so a single ``configure(enabled=False)`` (or
``REPRO_TELEMETRY=0`` in the environment) turns the WHOLE substrate into
cheap no-ops. Telemetry has no numerical footprint by construction — it
only records host-side scalars that the runtime already computed — and the
off switch also buys back the (small) host bookkeeping cost.

Sinks:

* ``jsonl_path`` — every closed span / event is appended as one JSON
  line (the live event stream; ``None`` disables it);
* ``flight_dir`` — directory for flight-recorder crash dumps (``None``
  keeps the ring in memory only; set ``REPRO_FLIGHT_DIR`` or call
  ``configure(flight_dir=...)`` to get on-disk postmortems).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

_LOCK = threading.Lock()

_STATE: Dict[str, Any] = {
    "enabled": os.environ.get("REPRO_TELEMETRY", "1").strip() not in
    ("0", "false", "off", ""),
    "jsonl_path": os.environ.get("REPRO_TELEMETRY_JSONL") or None,
    "flight_dir": os.environ.get("REPRO_FLIGHT_DIR") or None,
}


def enabled() -> bool:
    return _STATE["enabled"]


def flight_dir() -> Optional[str]:
    return _STATE["flight_dir"]


def jsonl_path() -> Optional[str]:
    return _STATE["jsonl_path"]


def configure(*, enabled: Optional[bool] = None,
              jsonl_path: Optional[str] = None,
              flight_dir: Optional[str] = None,
              clear_sinks: bool = False) -> Dict[str, Any]:
    """Reconfigure the process-wide telemetry state; returns the previous
    state (pass its fields back to restore — see ``obs.override``)."""
    with _LOCK:
        prev = dict(_STATE)
        if clear_sinks:
            _STATE["jsonl_path"] = None
            _STATE["flight_dir"] = None
        if enabled is not None:
            _STATE["enabled"] = bool(enabled)
        if jsonl_path is not None:
            _STATE["jsonl_path"] = jsonl_path
        if flight_dir is not None:
            _STATE["flight_dir"] = flight_dir
    return prev


def emit_jsonl(obj: Dict[str, Any]) -> None:
    """Append one record to the JSONL event stream (no-op when the sink is
    unset or telemetry is off). Failures to write never propagate into the
    runtime — telemetry must not be able to crash training."""
    path = _STATE["jsonl_path"]
    if not path or not _STATE["enabled"]:
        return
    try:
        line = json.dumps(obj, default=str)
        with _LOCK:
            with open(path, "a") as f:
                f.write(line + "\n")
    except OSError:
        pass
