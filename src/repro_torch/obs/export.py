"""Run-telemetry export: the per-run ``RUN_TELEMETRY.json`` summary.

One JSON document per run — the metrics snapshot plus run identity —
written at the end of a streaming run or a bench. The schema is the JAX
package's, flat and versioned, so one consumer reads the documents of
both packages without importing either.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.metrics import prometheus_snapshot  # re-export  # noqa: F401

SCHEMA = "repro.run_telemetry.v1"

#: Required top-level keys — the round-trip test asserts on these.
REQUIRED_KEYS = ("schema", "run", "counters", "gauges", "histograms")


def run_telemetry(run: Optional[Dict[str, Any]] = None,
                  registry: Optional[_metrics.MetricsRegistry] = None
                  ) -> Dict[str, Any]:
    """Build the RUN_TELEMETRY document from a registry snapshot."""
    snap = (registry or _metrics.REGISTRY).snapshot()
    return {
        "schema": SCHEMA,
        "run": dict(run or {}),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
    }


def write_run_telemetry(path: str,
                        run: Optional[Dict[str, Any]] = None,
                        registry: Optional[_metrics.MetricsRegistry] = None
                        ) -> Dict[str, Any]:
    doc = run_telemetry(run, registry)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
    return doc


def load_run_telemetry(path: str) -> Dict[str, Any]:
    """Load + validate a RUN_TELEMETRY.json; raises ValueError on a
    document that doesn't match the schema."""
    with open(path) as f:
        doc = json.load(f)
    missing = [k for k in REQUIRED_KEYS if k not in doc]
    if missing:
        raise ValueError(f"RUN_TELEMETRY missing keys: {missing}")
    if doc["schema"] != SCHEMA:
        raise ValueError(f"unknown RUN_TELEMETRY schema: {doc['schema']!r}")
    for k in ("counters", "gauges", "histograms"):
        if not isinstance(doc[k], dict):
            raise ValueError(f"RUN_TELEMETRY[{k!r}] must be an object")
    return doc
