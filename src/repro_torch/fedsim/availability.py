"""Client churn traces: who is online when, replayable bit-for-bit.  A numpy
copy of ``repro.fedsim.availability``: the same seed draws the same trace,
and a trace saved by either package loads in the other bit for bit.

The runtime never consumes a stochastic availability *process* directly — it
consumes an :class:`AvailabilityTrace`: per-client sorted disjoint half-open
``[start, end)`` on-intervals up to a horizon.  Generators materialize the
three churn families into traces, exactly the way ``comm.table3_trace``
materializes Table III's drop settings:

- :func:`always_on_trace` — every client online for the whole horizon (the
  degenerate no-churn case the sync/async equivalence tests pin down);
- :func:`duty_cycle_trace` — periodic duty-cycling with a deterministic
  per-client phase stagger (mobile clients on a charging schedule);
- :func:`markov_trace` — seeded two-state Markov process in continuous time
  (exponential on/off sojourns), the standard churn model.

Traces round-trip through JSON *bit-identically* (:func:`save_trace` /
:func:`load_trace` — Python's json writes ``repr`` floats, which parse back
to the same IEEE-754 doubles), so an experiment's churn is a shareable,
diffable artifact rather than an RNG side effect.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

Interval = tuple[float, float]


@dataclass
class AvailabilityTrace:
    """Per-client on-intervals over ``[0, horizon)``; the runtime's only view
    of churn.  ``intervals[i]`` is sorted, disjoint, and clipped to the
    horizon; ``meta`` records provenance (generator name + parameters)."""

    horizon: float
    intervals: list[list[Interval]]
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        for i, ivs in enumerate(self.intervals):
            prev_end = -1.0
            for s, e in ivs:
                if not (0.0 <= s < e <= self.horizon):
                    raise ValueError(f"client {i}: bad interval [{s}, {e})")
                if s < prev_end:
                    raise ValueError(f"client {i}: overlapping/unsorted intervals")
                prev_end = e
            # coalesce touching intervals ([0,10),[10,20) -> [0,20)): a client
            # online across the boundary must NOT emit a depart/join edge pair
            # there — that would fabricate churn (cancelled in-flight work)
            # for a continuously available client
            merged: list[Interval] = []
            for s, e in ivs:
                if merged and merged[-1][1] == s:
                    merged[-1] = (merged[-1][0], e)
                else:
                    merged.append((s, e))
            self.intervals[i] = merged

    @property
    def n_clients(self) -> int:
        return len(self.intervals)

    def available(self, client: int, t: float) -> bool:
        return any(s <= t < e for s, e in self.intervals[client])

    def available_at(self, t: float) -> list[int]:
        return [i for i in range(self.n_clients) if self.available(i, t)]

    def edges(self, client: int) -> list[tuple[float, bool]]:
        """(time, is_join) churn edges for one client, time-sorted."""
        out: list[tuple[float, bool]] = []
        for s, e in self.intervals[client]:
            out.append((s, True))
            if e < self.horizon:
                out.append((e, False))
        return out

    def uptime(self, client: int) -> float:
        return sum(e - s for s, e in self.intervals[client])


def always_on_trace(n_clients: int, horizon: float) -> AvailabilityTrace:
    """No churn: the degenerate trace the sync/async equivalence tests use."""
    return AvailabilityTrace(
        horizon,
        [[(0.0, float(horizon))] for _ in range(n_clients)],
        meta={"kind": "always_on", "n_clients": n_clients},
    )


def duty_cycle_trace(
    n_clients: int,
    horizon: float,
    *,
    period: float,
    on_fraction: float,
    stagger: bool = True,
) -> AvailabilityTrace:
    """Periodic duty-cycling: client i is on for ``on_fraction * period`` of
    every period, phase-shifted by ``i * period / n_clients`` when staggered
    (so the fleet is never simultaneously dark)."""
    if period <= 0.0:
        raise ValueError(f"period must be > 0, got {period}")
    if not 0.0 < on_fraction <= 1.0:
        raise ValueError(f"on_fraction must be in (0, 1], got {on_fraction}")
    on_len = on_fraction * period
    intervals: list[list[Interval]] = []
    for i in range(n_clients):
        phase = (i * period / n_clients) if stagger else 0.0
        ivs: list[Interval] = []
        k = -1  # the phase shift can pull the first window before t=0
        while True:
            s = k * period + phase
            e = s + on_len
            if s >= horizon:
                break
            if e > 0.0:
                ivs.append((max(s, 0.0), min(e, horizon)))
            k += 1
        intervals.append(ivs)
    return AvailabilityTrace(
        horizon,
        intervals,
        meta={
            "kind": "duty_cycle", "n_clients": n_clients,
            "period": period, "on_fraction": on_fraction, "stagger": stagger,
        },
    )


def markov_trace(
    n_clients: int,
    horizon: float,
    *,
    mean_on: float,
    mean_off: float,
    seed: int = 0,
) -> AvailabilityTrace:
    """Seeded two-state Markov churn: alternating Exp(1/mean_on) on-sojourns
    and Exp(1/mean_off) off-sojourns per client; the initial state is drawn
    from the stationary distribution.  ``mean_off / (mean_on + mean_off)`` is
    the churn (offline) fraction — sweep ``mean_off`` for churn-rate curves."""
    if mean_on <= 0 or mean_off < 0:
        raise ValueError("mean_on must be > 0 and mean_off >= 0")
    rng = np.random.default_rng(seed)
    intervals: list[list[Interval]] = []
    for _ in range(n_clients):
        if mean_off == 0.0:
            intervals.append([(0.0, float(horizon))])
            continue
        on = rng.random() < mean_on / (mean_on + mean_off)
        t, ivs = 0.0, []
        while t < horizon:
            dur = float(rng.exponential(mean_on if on else mean_off))
            if on and dur > 0.0:
                ivs.append((t, min(t + dur, float(horizon))))
            t += dur
            on = not on
        intervals.append(ivs)
    return AvailabilityTrace(
        horizon,
        intervals,
        meta={
            "kind": "markov", "n_clients": n_clients,
            "mean_on": mean_on, "mean_off": mean_off, "seed": seed,
        },
    )


def save_trace(trace: AvailabilityTrace, path) -> None:
    with open(path, "w") as f:
        json.dump(
            {
                "horizon": trace.horizon,
                "intervals": [[[s, e] for s, e in ivs] for ivs in trace.intervals],
                "meta": trace.meta,
            },
            f,
        )


def load_trace(path) -> AvailabilityTrace:
    with open(path) as f:
        raw = json.load(f)
    return AvailabilityTrace(
        float(raw["horizon"]),
        [[(float(s), float(e)) for s, e in ivs] for ivs in raw["intervals"]],
        dict(raw.get("meta", {})),
    )
