"""Declarative SLOs with multi-window burn-rate alerting.

A copy of ``repro.obs.slo`` (pure Python).

The serving plane measures latencies and availability; this module turns
them into *objectives* — "99% of requests complete under X seconds",
"no client's trim rate exceeds R" — evaluated continuously over sliding
windows of the observation stream, the way an SRE error-budget policy does:

- An :class:`Slo` declares a good-fraction ``target`` (e.g. ``0.99``) and,
  for threshold-style objectives, a ``bound`` — a sample is *bad* when its
  value exceeds the bound (latency over the limit, trim rate over budget).
  Availability-style objectives feed booleans instead (``ok=False`` is bad).
- The error **budget** is ``1 - target``; the **burn rate** of a window is
  its bad fraction divided by the budget (burn 1.0 = consuming budget
  exactly as fast as the objective allows; burn 10 = ten times too fast).
- **Multi-window** alerting requires the burn to exceed the threshold in a
  *fast* window (catches the spike quickly) AND a *slow* window (rejects
  one-sample blips) simultaneously — the standard fast/slow pair that keeps
  both detection latency and false-positive rate low.

Alerts are edge-triggered: one typed :class:`SloViolation` record lands in
:attr:`SloEngine.history` when an objective *enters* violation, and the
engine re-arms once the fast window recovers.  Every violation also counts
into the metrics registry (``slo.violations`` labeled by objective), and the
record set alone reconstructs the alert timeline — the bench contract.

Timestamps are caller-supplied, so the engine works identically on the
fedsim virtual clock (the serving benches) and on wall time.

The quarantine loop: :meth:`SloEngine.feed_quarantine` lifts the
``robust.trim_quarantine`` per-member ledger (``probes.quarantine_totals``)
into an availability-style objective — the *worst* member's trim rate is
observed against the bound, so a single client repeatedly trimmed by the
robust aggregation rules raises a violation naming that member.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.obs.probes import quarantine_totals
from repro_torch.obs.records import Record
from repro_torch.obs.registry import get_registry


@dataclass(eq=True)
class SloViolation(Record):
    """One edge-triggered objective violation (JSON-ready via ``to_dict``)."""

    t: float  # observation time the objective entered violation
    objective: str
    kind: str  # "latency" | "availability" | caller-chosen label
    burn_fast: float  # fast-window burn rate at the crossing
    burn_slow: float  # slow-window burn rate at the crossing
    budget: float  # 1 - target
    window_fast_s: float
    window_slow_s: float
    samples_fast: int
    samples_slow: int
    bound: float | None = None  # threshold objectives: the per-sample cut
    detail: str | None = None  # e.g. "member=3" for the quarantine objective


@dataclass(frozen=True)
class Slo:
    """One declarative objective.

    ``target`` is the good fraction (0 < target < 1); ``bound`` makes the
    objective threshold-style (bad when ``value > bound``), ``bound=None``
    availability-style (bad when ``ok`` is falsy).  ``burn_threshold`` is
    the burn rate BOTH windows must exceed to alert.
    """

    name: str
    target: float
    bound: float | None = None
    kind: str = "latency"
    window_fast_s: float = 5.0
    window_slow_s: float = 60.0
    burn_threshold: float = 1.0
    min_samples: int = 1

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"slo {self.name!r}: target must be in (0, 1), got {self.target}")
        if not 0.0 < self.window_fast_s < self.window_slow_s:
            raise ValueError(
                f"slo {self.name!r}: need 0 < fast window < slow window, got "
                f"{self.window_fast_s}, {self.window_slow_s}"
            )
        if self.burn_threshold <= 0:
            raise ValueError(f"slo {self.name!r}: burn_threshold must be > 0")
        if self.min_samples < 1:
            raise ValueError(f"slo {self.name!r}: min_samples must be >= 1")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def quarantine_slo(
    name: str = "robust.quarantine_rate",
    *,
    max_rate: float,
    target: float = 0.999,
    window_fast_s: float = 5.0,
    window_slow_s: float = 60.0,
    burn_threshold: float = 1.0,
) -> Slo:
    """An availability-style objective over the per-member trim ledger:
    violated when any client's cumulative trim rate exceeds ``max_rate``."""
    return Slo(
        name=name, target=target, bound=max_rate, kind="availability",
        window_fast_s=window_fast_s, window_slow_s=window_slow_s,
        burn_threshold=burn_threshold,
    )


@dataclass
class _Stream:
    """Per-objective sliding sample windows (monotone caller timestamps).

    The fast window is a suffix of the slow one, so both are kept as deques
    with running bad-counts: append + evict-from-the-left keeps every
    observation O(1) amortized — the engine sits on the serving hot path
    (one observe per completed request), where re-scanning the slow window
    per sample would be quadratic in the sustained request rate."""

    samples: deque = field(default_factory=deque)  # slow window: (t, bad)
    fast: deque = field(default_factory=deque)  # fast-window suffix
    bad_slow: int = 0
    bad_fast: int = 0
    alerting: bool = False
    last_detail: str | None = None


class SloEngine:
    """Evaluates a set of :class:`Slo` objectives over observation streams."""

    def __init__(self, objectives: tuple | list = ()):
        self._slos: dict[str, Slo] = {}
        self._streams: dict[str, _Stream] = {}
        self.history: list[SloViolation] = []
        for slo in objectives:
            self.add(slo)

    def add(self, slo: Slo) -> Slo:
        if slo.name in self._slos:
            raise ValueError(f"objective {slo.name!r} already registered")
        self._slos[slo.name] = slo
        self._streams[slo.name] = _Stream()
        return slo

    def has(self, name: str) -> bool:
        return name in self._slos

    def objective(self, name: str) -> Slo:
        return self._slos[name]

    def objectives(self) -> list[Slo]:
        return list(self._slos.values())

    # -- observation + evaluation --------------------------------------------

    def observe(
        self, name: str, t: float, value: float | None = None, *,
        ok: bool | None = None, detail: str | None = None,
    ) -> SloViolation | None:
        """Feed one sample and re-evaluate; returns the violation if this
        observation tipped the objective into alert (else None)."""
        slo = self._slos.get(name)
        if slo is None:
            raise KeyError(f"unknown objective {name!r} (add() it first)")
        if (value is None) == (ok is None):
            raise ValueError("pass exactly one of value= or ok=")
        if value is not None and slo.bound is None:
            raise ValueError(
                f"objective {name!r} is availability-style (no bound); feed ok="
            )
        bad = (float(value) > slo.bound) if value is not None else (not ok)
        stream = self._streams[name]
        sample = (float(t), bad)
        stream.samples.append(sample)
        stream.fast.append(sample)
        stream.bad_slow += bad
        stream.bad_fast += bad
        if detail is not None:
            stream.last_detail = detail
        while stream.samples and stream.samples[0][0] < t - slo.window_slow_s:
            stream.bad_slow -= stream.samples.popleft()[1]
        while stream.fast and stream.fast[0][0] < t - slo.window_fast_s:
            stream.bad_fast -= stream.fast.popleft()[1]
        return self._evaluate(slo, stream, float(t))

    def _evaluate(self, slo: Slo, stream: _Stream, t: float) -> SloViolation | None:
        n_fast, bad_fast = len(stream.fast), stream.bad_fast
        n_slow, bad_slow = len(stream.samples), stream.bad_slow
        burn_fast = (bad_fast / n_fast / slo.budget) if n_fast else 0.0
        burn_slow = (bad_slow / n_slow / slo.budget) if n_slow else 0.0
        reg = get_registry()
        reg.gauge("slo.burn").set(burn_fast, objective=slo.name, window="fast")
        reg.gauge("slo.burn").set(burn_slow, objective=slo.name, window="slow")
        firing = (
            n_fast >= slo.min_samples
            and n_slow >= slo.min_samples
            and burn_fast >= slo.burn_threshold
            and burn_slow >= slo.burn_threshold
        )
        if not firing:
            stream.alerting = False
            return None
        if stream.alerting:
            return None  # already inside this violation episode
        stream.alerting = True
        violation = SloViolation(
            t=t, objective=slo.name, kind=slo.kind,
            burn_fast=burn_fast, burn_slow=burn_slow, budget=slo.budget,
            window_fast_s=slo.window_fast_s, window_slow_s=slo.window_slow_s,
            samples_fast=n_fast, samples_slow=n_slow,
            bound=slo.bound, detail=stream.last_detail,
        )
        self.history.append(violation)
        reg.counter("slo.violations").inc(objective=slo.name)
        return violation

    # -- quarantine-ledger plumbing (probes -> alerting) ---------------------

    def feed_quarantine(
        self, t: float, *, objective: str, rounds: int,
        totals: dict[int, float] | None = None, registry=None,
        kind: str | None = None,
    ) -> SloViolation | None:
        """Observe the worst per-member trim rate from the fault ledger.

        ``totals`` defaults to :func:`repro_torch.obs.probes.quarantine_totals`
        (the ``robust.trim_quarantine`` counter); ``rounds`` normalizes the
        cumulative mass into a rate.  No members trimmed yet counts as a
        clean (rate 0) sample, so the windows still advance.
        """
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if totals is None:
            totals = quarantine_totals(registry, kind=kind)
        if not totals:
            return self.observe(objective, t, value=0.0, detail=None)
        worst = max(totals, key=lambda m: totals[m])
        rate = totals[worst] / rounds
        return self.observe(objective, t, value=rate, detail=f"member={worst}")
