"""Telemetry: the metrics registry and the comm ledger's typed record.

``metrics()`` is the active registry (the no-op ``NULL`` unless one was set).
"""
from repro_torch.obs.records import CommRecord, Record
from repro_torch.obs.registry import (
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    get_registry,
    set_registry,
    use_registry,
)

metrics = get_registry

__all__ = [
    "NULL", "CommRecord", "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "Record", "get_registry", "metrics", "set_registry", "use_registry",
]
