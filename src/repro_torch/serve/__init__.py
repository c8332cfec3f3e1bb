"""Adaptation-as-a-service: a persistent aligner server over fitted RF-TCA
states, on the card.

Port of ``repro.serve``: a model store (LRU + version-tagged invalidation),
a batching dispatcher that coalesces concurrent requests into bucketed
dispatches (the K1 kernel featurizes each), a live-admission path that joins
new clients over the real wire with an incremental moment merge (no refit),
and an open-loop Poisson load generator over the fedsim virtual clock.

Request-level observability attaches via ``AlignerServer.attach``: per-request
span trees (``obs.RequestTracer``), latency SLOs with burn-rate alerting
(``obs.SloEngine``), and RF-MMD drift detection over the moments streamed out
of the probed dispatch planes (``obs.DriftMonitor``) — a confirmed drift alert
triggers ``refresh_from_moments``, a statistics-space re-solve with exactly
one version bump.  Everything is off by default and bit for bit inert when off.
"""
from repro_torch.serve.admission import (
    AdmissionGateway,
    AdmissionResult,
    admission_message,
    client_moment,
)
from repro_torch.serve.dispatcher import BatchingDispatcher, Request
from repro_torch.serve.loadgen import LoadResult, poisson_arrivals, run_open_loop, synth_requests
from repro_torch.serve.server import AlignerServer
from repro_torch.serve.store import ModelStore, MomentStats, StoreEntry

__all__ = [
    "AdmissionGateway",
    "AdmissionResult",
    "AlignerServer",
    "BatchingDispatcher",
    "LoadResult",
    "ModelStore",
    "MomentStats",
    "Request",
    "StoreEntry",
    "admission_message",
    "client_moment",
    "poisson_arrivals",
    "run_open_loop",
    "synth_requests",
]
