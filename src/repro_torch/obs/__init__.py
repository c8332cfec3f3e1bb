"""Telemetry: metrics, virtual-time tracing, plane sentinels, health probes,
request traces, SLOs and drift detection.

Port of ``repro.obs``, every name it exports:

- :mod:`~repro_torch.obs.registry` — labelled counters, gauges and
  histograms; ``metrics()`` is the active registry (the no-op ``NULL``
  unless one was set);
- :mod:`~repro_torch.obs.tracing` — virtual and wall-clock spans as Chrome
  trace-event JSON; ``get_tracer()`` is the active :class:`Tracer` (None:
  tracing off);
- :mod:`~repro_torch.obs.sentinel` — argument signatures per plane (where
  the reference counts jit retraces);
- :mod:`~repro_torch.obs.records` — typed history and ledger records;
- :mod:`~repro_torch.obs.probes` — host-side emission of the engine's probes;
- :mod:`~repro_torch.obs.reqtrace` — head-sampled per-request span trees;
- :mod:`~repro_torch.obs.slo` — declarative SLOs with burn-rate alerts;
- :mod:`~repro_torch.obs.drift` — RF-MMD drift detection over live moments.
"""
from repro_torch.obs import sentinel
from repro_torch.obs.drift import DriftMonitor, DriftRecord
from repro_torch.obs.probes import emit_probes, quarantine_totals
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
from repro_torch.obs.reqtrace import RequestTracer
from repro_torch.obs.slo import Slo, SloEngine, SloViolation, quarantine_slo
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
    "NULL", "PID_VIRTUAL", "PID_WALL", "CommRecord", "Counter", "CrashRecord", "DriftMonitor",
    "DriftRecord", "EvalRecord", "FlushRecord", "Gauge", "Histogram", "MetricsRegistry",
    "NullRegistry", "Record", "RequestTracer", "RoundRecord", "Slo", "SloEngine", "SloViolation",
    "Tracer", "as_rows", "count_request_trees", "emit_probes", "get_registry", "get_tracer",
    "metrics", "quarantine_slo", "quarantine_totals", "sentinel", "set_registry", "set_tracer",
    "use_registry", "use_tracer", "validate_trace", "validate_trace_file",
]
