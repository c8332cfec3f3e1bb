"""Telemetry: the metrics registry, virtual-time tracing and typed records.

``metrics()`` is the active registry (the no-op ``NULL`` unless one was set);
``get_tracer()`` the active :class:`Tracer` (None: tracing off).  Port of
``repro.obs`` without its sentinel, probes, request tracing, SLOs and drift
monitor (ROADMAP queue 1 step 10).
"""
from repro_torch.obs.records import (
    CommRecord,
    CrashRecord,
    EvalRecord,
    FlushRecord,
    Record,
    RoundRecord,
    as_rows,
)
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
from repro_torch.obs.tracing import (
    PID_VIRTUAL,
    PID_WALL,
    Tracer,
    count_request_trees,
    get_tracer,
    set_tracer,
    use_tracer,
    validate_trace,
    validate_trace_file,
)

metrics = get_registry

__all__ = [
    "NULL", "PID_VIRTUAL", "PID_WALL", "CommRecord", "Counter", "CrashRecord", "EvalRecord",
    "FlushRecord", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry", "Record",
    "RoundRecord", "Tracer", "as_rows", "count_request_trees", "get_registry", "get_tracer",
    "metrics", "set_registry", "set_tracer", "use_registry", "use_tracer", "validate_trace",
    "validate_trace_file",
]
