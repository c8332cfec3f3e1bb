"""Open-loop Poisson load generation over the fedsim virtual clock.

Port of ``repro.serve.loadgen`` (host-side Python over the port's
``fedsim.clock`` and ``fedsim.events``): the same seeds give the same
arrivals and request mix, bit for bit.

Arrivals are an open-loop Poisson process: interarrival gaps are exponential
draws at the offered rate, generated up front and pushed as
:class:`~repro_torch.fedsim.events.RequestArrived` events — the generator never
waits for the server, so queueing delay under overload is *measured*, not
hidden (the closed-loop fallacy).

Service is the real thing: when the (single-server) dispatch loop goes idle
and requests are pending, a head-of-line run against one domain pair becomes
an actual dispatch through :class:`~repro_torch.serve.server.AlignerServer`
— wall-clock service time is measured around it (it ends in the result's copy
to the host) and mapped into virtual seconds, and a
:class:`~repro_torch.fedsim.events.RequestCompleted`
event fires per request at the batch's virtual finish time.  Latency is
completion minus arrival, so the p50/p99-vs-offered-load curve in
``BENCH_serve.json`` reflects genuine queueing + batching dynamics: higher
load -> fuller buckets -> better throughput per dispatch, until saturation.

Determinism: the arrival schedule and request mix are pure functions of the
seed.  Service *times* are wall-clock (hence load-dependent), but the event
sequence under a fixed seed replays the identical arrival order (FIFO heap
ties), and the arrays never depend on timing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.fedsim.clock import EventQueue, VirtualClock
from repro_torch.fedsim.events import RequestArrived, RequestCompleted
from repro_torch.obs import PID_WALL, get_tracer, metrics
from repro_torch.serve.dispatcher import Request


@dataclass
class LoadResult:
    """One load level's measurements (JSON-ready via :meth:`summary`)."""

    offered_rps: float
    latencies: dict[int, float] = field(default_factory=dict)  # id -> seconds
    horizon: float = 0.0  # virtual time of the last completion
    batches: int = 0
    batch_sizes: list[int] = field(default_factory=list)  # requests per batch
    service_scale: float = 1.0  # wall->virtual calibration used for the run

    def summary(self) -> dict:
        lats = np.array(sorted(self.latencies.values()), dtype=np.float64)
        if lats.size == 0:
            raise RuntimeError("load run completed no requests")
        return {
            "offered_rps": self.offered_rps,
            "completed": int(lats.size),
            "throughput_rps": float(lats.size / self.horizon) if self.horizon > 0 else 0.0,
            "p50_ms": float(np.percentile(lats, 50) * 1e3),
            "p99_ms": float(np.percentile(lats, 99) * 1e3),
            "mean_ms": float(lats.mean() * 1e3),
            "mean_batch": float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0,
            "max_batch": int(max(self.batch_sizes)) if self.batch_sizes else 0,
            "service_scale": float(self.service_scale),
        }


def poisson_arrivals(rate: float, n: int, *, seed: int) -> np.ndarray:
    """Cumulative arrival times of ``n`` Poisson arrivals at ``rate`` req/s."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def synth_requests(
    keys,
    *,
    dim: int,
    n_requests: int,
    seed: int,
    cols_lo: int = 4,
    cols_hi: int = 32,
    mode: str = "transform",
    shift: float = 0.0,
) -> list[Request]:
    """A deterministic request mix: random key, random column count.

    ``shift`` offsets every sample column (covariate shift injection for the
    drift bench: requests drawn at ``shift != 0`` simulate a target
    distribution that moved after the aligner was fitted)."""
    rng = np.random.default_rng(seed + 1)
    reqs = []
    for i in range(n_requests):
        key = keys[int(rng.integers(len(keys)))]
        n_cols = int(rng.integers(cols_lo, cols_hi + 1))
        x = (rng.standard_normal((dim, n_cols)) + shift).astype(np.float32)
        reqs.append(Request(x=x, key=key, mode=mode, id=i))
    return reqs


def run_open_loop(
    server,
    requests: list[Request],
    *,
    rate: float,
    seed: int = 0,
    service_scale: float = 1.0,
    slo_objective: str = "serve.latency",
) -> LoadResult:
    """Drive ``requests`` through ``server`` as an open-loop Poisson stream.

    ``service_scale`` maps measured wall seconds of a dispatch into virtual
    seconds (1.0 = real time; must be a positive finite calibration factor);
    the arrival process always runs in virtual time, so offered load and
    service capacity share one clock.

    Observability attached to the server rides along: requests head-sampled
    by ``server.reqtrace`` get full span trees (queue-wait / batch-assembly /
    padded-dispatch legs in virtual time, processing legs mirrored on the
    wall track), completions feed ``server.slo``'s ``slo_objective`` when
    that objective is registered, and ``server.virtual_now`` is stamped
    before every dispatch so drift observations carry virtual timestamps.
    """
    if not (np.isfinite(service_scale) and service_scale > 0):
        raise ValueError(
            f"service_scale must be a positive finite factor, got {service_scale}"
        )
    arrivals = poisson_arrivals(rate, len(requests), seed=seed)
    reqs = list(requests)
    for i, (req, t) in enumerate(zip(reqs, arrivals)):
        req.id = i
        req.arrival = float(t)

    tracer = get_tracer()
    reqtracer = getattr(server, "reqtrace", None)
    slo = getattr(server, "slo", None)
    feed_slo = slo is not None and slo.has(slo_objective)

    def _tid(i: int) -> int:
        if tracer is None or reqtracer is None:
            return -1
        return i if reqtracer.sampled(i) else -1

    clock = VirtualClock()
    queue = EventQueue()
    for req in reqs:
        queue.push(req.arrival, RequestArrived(req.id, trace_id=_tid(req.id)))

    result = LoadResult(offered_rps=rate, service_scale=float(service_scale))
    pending: list[int] = []
    busy_until = 0.0

    def start_batch(now: float) -> float:
        """Serve one head-of-line same-key run; returns its virtual finish."""
        head_key = reqs[pending[0]].key
        batch_ids = [i for i in pending if reqs[i].key == head_key]
        # respect the dispatcher's ladder: one dispatch per batch
        cols, cut = 0, len(batch_ids)
        for j, i in enumerate(batch_ids):
            cols += int(reqs[i].x.shape[1])
            if j > 0 and cols > server.dispatcher.max_bucket:
                cut = j
                break
        batch_ids = batch_ids[:cut]
        server.virtual_now = now
        w0 = tracer.wall_now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        server.serve([reqs[i] for i in batch_ids])
        dt = (time.perf_counter() - t0) * service_scale
        finish = now + dt
        # wall-clock split of the serve into assembly vs dispatch,
        # from the dispatcher's leg log (one pair per dispatch)
        take = getattr(server.dispatcher, "take_legs", None)
        legs = take() if take is not None else []
        assemble = sum(a for a, _ in legs)
        dispatch = sum(d for _, d in legs)
        frac = assemble / (assemble + dispatch) if assemble + dispatch > 0 else 0.5
        for i in batch_ids:
            pending.remove(i)
            tid = i if (reqtracer is not None and reqtracer.active(i)) else -1
            queue.push(finish, RequestCompleted(i, trace_id=tid))
            if tid >= 0:
                arr = reqs[i].arrival
                reqtracer.leg(i, "serve.queue_wait", arr, now - arr)
                reqtracer.leg(i, "serve.batch_assembly", now, dt * frac)
                reqtracer.leg(i, "serve.padded_dispatch",
                              now + dt * frac, dt * (1 - frac))
                # wall twins of the processing legs (measured, not scaled)
                reqtracer.leg(i, "serve.batch_assembly", w0, assemble,
                              pid=PID_WALL)
                reqtracer.leg(i, "serve.padded_dispatch", w0 + assemble,
                              dispatch, pid=PID_WALL)
        result.batches += 1
        result.batch_sizes.append(len(batch_ids))
        if tracer is not None:
            tracer.complete("serve.batch", now, dt,
                            args={"requests": len(batch_ids), "key": str(head_key)})
        metrics().histogram("serve.service_s").observe(dt)
        return finish

    while len(queue):
        t, ev = queue.pop()
        clock.advance_to(t)
        if isinstance(ev, RequestArrived):
            pending.append(ev.request)
            if ev.trace_id >= 0:
                reqtracer.begin(ev.request, t)
        elif isinstance(ev, RequestCompleted):
            result.latencies[ev.request] = t - reqs[ev.request].arrival
            result.horizon = max(result.horizon, t)
            if feed_slo:
                slo.observe(slo_objective, t, result.latencies[ev.request])
            if reqtracer is not None:
                reqtracer.finish(ev.request, t)
        if pending and clock.now >= busy_until:
            busy_until = start_batch(clock.now)

    return result
