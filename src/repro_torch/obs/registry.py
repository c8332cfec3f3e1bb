"""Metrics registry: labeled counters, gauges and histograms.

A copy of ``repro.obs.registry`` (pure Python, no JAX).  The comm layer
emits wire bytes, messages and floats through it (``comm.transport``), the
network simulator its retries and uplink times (``comm.netsim``), and the
trainer its round counters.  The default registry is the no-op
:data:`NULL`, so a run that collects nothing pays one attribute lookup and
one empty call per instrument; :func:`use_registry` installs a collecting
one for a scope.
"""
from __future__ import annotations

import contextlib
import math


def _label_key(labels: dict) -> str:
    """Canonical series key: sorted ``k=v`` pairs (empty string when bare)."""
    if not labels:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class Counter:
    """Monotone accumulator (floats allowed: probe attributions accumulate)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.series: dict[str, float] = {}

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease (got {value})")
        key = _label_key(labels)
        self.series[key] = self.series.get(key, 0) + value

    def value(self, **labels) -> float:
        return self.series.get(_label_key(labels), 0)


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.series: dict[str, float] = {}

    def set(self, value: float, **labels) -> None:
        self.series[_label_key(labels)] = value

    def value(self, **labels) -> float | None:
        return self.series.get(_label_key(labels))


class Histogram:
    """Streaming summary per series: count / sum / min / max.

    A full quantile sketch would be overkill for the repo's needs (the bench
    records report count/mean/extremes); the summary is O(1) per observation
    and deterministic, which the trace/metric determinism tests rely on.
    """

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.series: dict[str, dict] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if math.isnan(value):
            raise ValueError(f"histogram {self.name}: NaN observation")
        key = _label_key(labels)
        s = self.series.get(key)
        if s is None:
            self.series[key] = {"count": 1, "sum": value, "min": value, "max": value}
        else:
            s["count"] += 1
            s["sum"] += value
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)

    def summary(self, **labels) -> dict | None:
        s = self.series.get(_label_key(labels))
        if s is None:
            return None
        return {**s, "mean": s["sum"] / s["count"]}


class MetricsRegistry:
    """Collecting registry: instruments are created on first use and cached
    by name, so call sites never pre-declare anything."""

    collecting = True

    def __init__(self):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"asked for {cls.__name__.lower()}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """The whole registry as nested plain dicts (JSON-ready)."""
        out: dict = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, Histogram):
                out[name] = {
                    k: {**s, "mean": s["sum"] / s["count"]}
                    for k, s in inst.series.items()
                }
            else:
                out[name] = dict(inst.series)
        return out


class _NullInstrument:
    """Shared no-op counter/gauge/histogram — the disabled-telemetry cost."""

    __slots__ = ()

    def inc(self, value: float = 1, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels):
        return None

    def summary(self, **labels):
        return None


class NullRegistry:
    """The default: every instrument is the shared no-op singleton."""

    collecting = False
    _inst = _NullInstrument()

    def counter(self, name: str) -> _NullInstrument:
        return self._inst

    def gauge(self, name: str) -> _NullInstrument:
        return self._inst

    def histogram(self, name: str) -> _NullInstrument:
        return self._inst

    def snapshot(self) -> dict:
        return {}


NULL = NullRegistry()
_REGISTRY: MetricsRegistry | NullRegistry = NULL


def get_registry() -> MetricsRegistry | NullRegistry:
    """The active registry (the no-op :data:`NULL` unless one was set)."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry | NullRegistry | None) -> None:
    """Install ``registry`` process-wide (None restores the no-op default)."""
    global _REGISTRY
    _REGISTRY = NULL if registry is None else registry


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry | None = None):
    """Scoped collection: installs ``registry`` (a fresh one when None),
    yields it, and restores the previous registry on exit."""
    reg = MetricsRegistry() if registry is None else registry
    prev = _REGISTRY
    set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)
