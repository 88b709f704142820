"""Process-wide metrics registry: counters, gauges, bounded-window
histograms.

Three metric kinds, one naming scheme (dotted ``layer.signal`` names, the
JAX package's: ``walk.supersteps``, ``train.steps``, ``span.ckpt.write.s``):

* ``Counter`` — monotonically-increasing totals (events, bytes, steps);
* ``Gauge``   — last-write-wins instantaneous values (pool sizes, EMAs);
* ``Histogram`` — a BOUNDED sliding-window reservoir of recent
  observations with lifetime count/sum/min/max; every ``trace_span``
  duration lands in a ``span.<name>.s`` histogram.

The registry is deliberately host-only and lock-cheap: recording a value
is a dict lookup + a float add under the GIL. Nothing in this module may
ever touch a device tensor — callers pull device scalars to the host first
(and only where the runtime already did), which keeps telemetry on and off
bit-identical by construction.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, Iterable, Optional

import numpy as np

from repro_torch.obs import config as _config

DEFAULT_WINDOW = 256


class Reservoir:
    """Bounded sliding window of the most recent observations.

    The percentile substrate of ``Histogram``: keeps the last ``window`` values in a
    deque (O(1) add, O(window) percentile) — percentiles over recent
    behaviour, not over the whole run, which is what an SLO wants.
    """

    __slots__ = ("_values",)

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._values: collections.deque = collections.deque(
            maxlen=max(int(window), 1))

    def add(self, value: float) -> None:
        self._values.append(float(value))

    def values(self) -> np.ndarray:
        return np.asarray(self._values, np.float64)

    def percentile(self, q: float) -> Optional[float]:
        if not self._values:
            return None
        return float(np.percentile(self.values(), q))

    def __len__(self) -> int:
        return len(self._values)

    @property
    def window(self) -> int:
        return self._values.maxlen


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Lifetime count/sum/min/max plus a bounded percentile window."""

    __slots__ = ("name", "count", "sum", "min", "max", "reservoir")

    def __init__(self, name: str = "", window: int = DEFAULT_WINDOW):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.reservoir = Reservoir(window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.reservoir.add(v)

    def values(self) -> np.ndarray:
        """Window contents (the percentile substrate)."""
        return self.reservoir.values()

    def percentile(self, q: float) -> Optional[float]:
        return self.reservoir.percentile(q)

    def summary(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "window": self.reservoir.window,
        }


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    ``attach`` registers an externally-owned histogram (one whose window
    its owner configures), which the registry then exports.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(self, name: str, window: int = DEFAULT_WINDOW) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, window)
            return m

    def attach(self, name: str, hist: Histogram) -> Histogram:
        """Register (or replace) an externally-owned histogram."""
        with self._lock:
            hist.name = name
            self._histograms[name] = hist
            return hist

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()
                           if g.value is not None},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }


#: The process-wide default registry (module-level helpers target it).
REGISTRY = MetricsRegistry()


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_snapshot(registry: MetricsRegistry = REGISTRY,
                        prefix: str = "repro") -> str:
    """Prometheus text-exposition snapshot of the registry.

    Histograms export ``_count``/``_sum`` plus window quantiles as
    labelled gauges (a true cumulative-bucket export needs fixed bucket
    bounds the runtime cannot know a priori; the bounded-window quantiles
    are what operators actually alert on)."""
    snap = registry.snapshot()
    lines = []
    for name, value in sorted(snap["counters"].items()):
        m = f"{prefix}_{_sanitize(name)}"
        lines += [f"# TYPE {m} counter", f"{m} {value:g}"]
    for name, value in sorted(snap["gauges"].items()):
        m = f"{prefix}_{_sanitize(name)}"
        lines += [f"# TYPE {m} gauge", f"{m} {value:g}"]
    for name, summ in sorted(snap["histograms"].items()):
        m = f"{prefix}_{_sanitize(name)}"
        lines.append(f"# TYPE {m} summary")
        lines.append(f"{m}_count {summ.get('count', 0):g}")
        lines.append(f"{m}_sum {summ.get('sum', 0.0):g}")
        for q in (50, 90, 99):
            v = summ.get(f"p{q}")
            if v is not None:
                lines.append(f'{m}{{quantile="0.{q}"}} {v:g}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Gated module-level helpers — the instrumentation call surface.
# One flag check + one dict lookup when on; one flag check when off.
# ---------------------------------------------------------------------------


def inc(name: str, v: float = 1.0) -> None:
    if _config.enabled():
        REGISTRY.counter(name).inc(v)


def set_gauge(name: str, v: float) -> None:
    if _config.enabled():
        REGISTRY.gauge(name).set(v)


def observe(name: str, v: float, window: int = DEFAULT_WINDOW) -> None:
    if _config.enabled():
        REGISTRY.histogram(name, window).observe(v)


def set_gauges(prefix: str, values: Iterable[float]) -> None:
    """Per-shard convenience: ``set_gauges("walk.occ", [a, b])`` sets
    ``walk.occ.shard0`` and ``walk.occ.shard1``."""
    if _config.enabled():
        for i, v in enumerate(values):
            REGISTRY.gauge(f"{prefix}.shard{i}").set(v)
