"""Runtime telemetry of the port, the JAX package's ``obs`` copied.

Four pieces behind one switch:

* ``metrics``  — process-wide registry of counters / gauges / bounded-
  window histograms (``inc`` / ``set_gauge`` / ``observe``);
* ``trace``    — nested ``trace_span`` phase timing that shares fields
  with ``common.logging.log_context``;
* ``recorder`` — bounded ring of recent spans/events, dumped to disk as
  a postmortem when a fault / divergence / retry path fails;
* ``export``   — Prometheus text snapshot + per-run RUN_TELEMETRY.json.

The whole substrate is host-side bookkeeping over scalars the runtime
already pulled to the host (it adds no device synchronisation): telemetry
on and off give bit-equal phi (``tests/test_torch_obs.py``), and
``REPRO_TELEMETRY=0`` / ``configure(enabled=False)`` turns every entry
point into a flag check. The switches are the JAX package's environment
variables, so one setting governs both packages.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from repro_torch.obs.config import configure, emit_jsonl, enabled  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
    inc,
    observe,
    prometheus_snapshot,
    set_gauge,
    set_gauges,
)
from repro_torch.obs.recorder import (  # noqa: F401
    dump_flight_record,
    load_flight_record,
    recent,
)
from repro_torch.obs.trace import (  # noqa: F401
    ambient_fields,
    current_span,
    span_event,
    span_stack,
    trace_span,
)
from repro_torch.obs.export import (  # noqa: F401
    load_run_telemetry,
    run_telemetry,
    write_run_telemetry,
)

from repro_torch.obs import recorder as _recorder


@contextlib.contextmanager
def override(**kwargs) -> Iterator[None]:
    """Temporarily reconfigure telemetry (tests / benches):

        with obs.override(enabled=False):
            ...  # telemetry fully off inside the block
    """
    prev = configure(**kwargs)
    try:
        yield
    finally:
        configure(enabled=prev["enabled"], clear_sinks=True)
        if prev["jsonl_path"]:
            configure(jsonl_path=prev["jsonl_path"])
        if prev["flight_dir"]:
            configure(flight_dir=prev["flight_dir"])


def reset() -> None:
    """Clear the registry and the flight-recorder ring (test isolation)."""
    REGISTRY.reset()
    _recorder.clear()
