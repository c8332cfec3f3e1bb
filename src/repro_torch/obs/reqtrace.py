"""Per-request span trees for the serving plane.

A copy of ``repro.obs.reqtrace`` (pure Python).

One sampled request becomes one span tree in the exported Chrome trace:
a ``serve.request`` root covering arrival -> completion with nested legs

    serve.queue_wait      arrival -> dispatch start
    serve.batch_assembly  host-side concat + pad + mask of the batch
    serve.padded_dispatch the bucketed dispatch (ends in its host copy)

recorded on the *virtual-time* track (the fedsim clock the load generator
runs on) and, for the serve-side processing legs, mirrored on the wall-clock
track — the same two-track convention as :mod:`repro_torch.obs.tracing`.  Each
sampled request gets its own ``tid`` lane and every event carries
``args.trace_id``, so trees stay distinguishable in Perfetto and countable
by :func:`repro_torch.obs.tracing.count_request_trees` (the CI smoke gate).

Admission is traced the same way: one ``serve.admission`` root per admitted
client with the protocol's three legs (``serve.wire_decode`` ->
``serve.moment_merge`` -> ``serve.w_rf_ship``) on the wall track — those
legs are real wire work, not simulated service time.

**Head-based sampling.**  Whether a request is traced is decided once, at
arrival, by a deterministic hash of its id (no RNG state, identical across
replays): ``rate=0`` disables tracing entirely and ``rate=1.0`` — every
request, test/bench-only — would be far too much trace volume in any real
deployment.  Emission goes to the ambient :func:`repro_torch.obs.tracing.
get_tracer`; with no tracer installed every method is a cheap no-op, which
keeps the telemetry-off serving path bitwise identical.
"""
from __future__ import annotations

from repro_torch.obs.tracing import PID_VIRTUAL, PID_WALL, get_tracer

# fixed-point Knuth multiplicative hash: uniform enough for head sampling,
# fully deterministic, and independent of Python's randomized str hash
_KNUTH = 2654435761
_GOLDEN = 0x9E3779B9
_REQUEST_TID_BASE = 10_000  # one lane per sampled request
_ADMISSION_TID_BASE = 50_000  # one lane per traced admission


class RequestTracer:
    """Head-sampled per-request span-tree recorder."""

    def __init__(self, rate: float = 1.0, *, seed: int = 0, tracer=None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sampling rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        self._tracer = tracer  # None -> the ambient get_tracer()
        self._open: dict[int, dict] = {}
        self.sampled_total = 0
        self.emitted = 0
        self.admissions = 0

    def _t(self):
        return self._tracer if self._tracer is not None else get_tracer()

    # -- sampling ------------------------------------------------------------

    def sampled(self, req_id: int) -> bool:
        """Deterministic head-sampling decision for ``req_id``."""
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        h = ((int(req_id) + 1) * _KNUTH + self.seed * _GOLDEN) & 0xFFFFFFFF
        return h < self.rate * 2**32

    # -- request trees -------------------------------------------------------

    def begin(self, req_id: int, arrival: float) -> bool:
        """Open a trace for ``req_id`` if sampled and a tracer is live."""
        if self._t() is None or not self.sampled(req_id):
            return False
        self._open[req_id] = {"arrival": float(arrival), "legs": []}
        self.sampled_total += 1
        return True

    def active(self, req_id: int) -> bool:
        return req_id in self._open

    def leg(self, req_id: int, name: str, t0: float, dur: float, *,
            pid: int = PID_VIRTUAL) -> None:
        """Record one leg of an open request (emitted at :meth:`finish`)."""
        rec = self._open.get(req_id)
        if rec is not None:
            rec["legs"].append((name, float(t0), max(float(dur), 0.0), pid))

    def finish(self, req_id: int, completion: float) -> None:
        """Close the request and emit its whole span tree to the tracer."""
        rec = self._open.pop(req_id, None)
        tracer = self._t()
        if rec is None or tracer is None:
            return
        tid = _REQUEST_TID_BASE + req_id
        args = {"trace_id": req_id}
        tracer.complete(
            "serve.request", rec["arrival"],
            max(float(completion) - rec["arrival"], 0.0),
            tid=tid, pid=PID_VIRTUAL, args=args,
        )
        for name, t0, dur, pid in rec["legs"]:
            tracer.complete(name, t0, dur, tid=tid, pid=pid, args=args)
        self.emitted += 1

    # -- admission trees -----------------------------------------------------

    def emit_admission(self, legs, *, wall0: float) -> None:
        """One wall-clock admission tree: ``legs`` is an ordered list of
        ``(name, duration_s)`` starting at ``wall0`` (tracer-relative)."""
        tracer = self._t()
        if tracer is None or not legs:
            return
        aid = self.admissions
        self.admissions += 1
        tid = _ADMISSION_TID_BASE + aid
        args = {"trace_id": -(aid + 1)}  # negative ids: admission namespace
        total = sum(max(float(d), 0.0) for _, d in legs)
        tracer.complete("serve.admission", wall0, total, tid=tid,
                        pid=PID_WALL, args=args)
        t = float(wall0)
        for name, dur in legs:
            dur = max(float(dur), 0.0)
            tracer.complete(name, t, dur, tid=tid, pid=PID_WALL, args=args)
            t += dur
