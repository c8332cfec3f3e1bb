"""Trace-driven network simulation for the federated protocol.

A copy of ``repro.comm.netsim`` (numpy only, the same plans and traces from
the same seed) over the port's ``federated.network`` and metrics registry.

Generalizes Table III's three drop settings into arbitrary, replayable
scenarios.  Every scenario emits the same :class:`federated.network.RoundPlan`
(nested participant sets A supseteq B supseteq C for moments / W_RF /
classifier) that both the serial and batched round engines already consume —
the engines never know which scenario produced the plan.

Scenarios:

- :class:`TableIIIScenario` — the paper's settings (I) A/A/A, (II) A/A/B,
  (III) A/B/C, bit-compatible with ``network.plan_round`` (the default).
- :class:`BernoulliScenario` — per-link i.i.d. Bernoulli loss with separate
  probabilities per payload kind; nesting enforced by intersection.
- :class:`LinkScenario` — per-client :class:`LinkModel` (latency, jitter,
  bandwidth, loss) against a round deadline: a client whose simulated
  delivery time exceeds the deadline is a straggler and counts as dropped.
  Uses the *exact* wire byte sizes, so heavier codecs genuinely straggle.
- :class:`TraceScenario` — an explicit list of round plans, replayed
  deterministically; any scenario can be recorded into one
  (:func:`record_trace`) and traces round-trip through JSON
  (:func:`save_trace` / :func:`load_trace`) for shareable experiments.
- :class:`CorruptionScenario` — payload-level corruption over any base
  scenario, in its *defended* (checksummed) form: a corrupted frame is
  rejected and retransmitted, so per-kind corruption rates compose into an
  extra erasure channel (give-up after ``max_retries``).  The undefended
  form — corrupted values reaching the aggregator — is the reference's
  ``repro.robust.faults``, not ported yet (ROADMAP queue 1 step 7).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.federated import network
from repro_torch.federated.network import RoundPlan, sample_participants
from repro_torch.obs.registry import get_registry


class Scenario:
    """Emits one RoundPlan per round: ``plan(rng, n_clients, t)``."""

    def plan(self, rng: np.random.Generator, n_clients: int, t: int) -> RoundPlan:
        raise NotImplementedError


@dataclass
class TableIIIScenario(Scenario):
    """Paper Table III settings as a scenario (delegates to plan_round)."""

    setting: str = "I"

    def plan(self, rng, n_clients, t) -> RoundPlan:
        # resolved through the module so tests can monkeypatch network.plan_round
        return network.plan_round(rng, n_clients, self.setting)


def _nest(a: list[int], b: list[int], c: list[int]) -> RoundPlan:
    """Enforce the protocol invariant C ⊆ B ⊆ A by intersection."""
    b = sorted(set(b) & set(a))
    c = sorted(set(c) & set(b))
    return RoundPlan(sorted(a), b, c)


@dataclass
class BernoulliScenario(Scenario):
    """Independent per-client, per-payload Bernoulli delivery.

    ``p_msg``/``p_w``/``p_c`` are *loss* probabilities for the moments, W_RF
    and classifier payloads.  ``sample_s_t=True`` additionally draws the
    paper's participating set S_t first (Section IV-B) so loss composes with
    client sampling; False exposes the pure-channel ablation.
    """

    p_msg: float = 0.0
    p_w: float = 0.0
    p_c: float = 0.0
    sample_s_t: bool = True

    def plan(self, rng, n_clients, t) -> RoundPlan:
        base = (
            sample_participants(rng, n_clients) if self.sample_s_t else list(range(n_clients))
        )
        a = [i for i in base if rng.random() >= self.p_msg]
        b = [i for i in a if rng.random() >= self.p_w]
        c = [i for i in b if rng.random() >= self.p_c]
        return _nest(a, b, c)


@dataclass
class LinkModel:
    """One client's uplink: Bernoulli loss + latency/jitter/bandwidth."""

    drop: float = 0.0  # Bernoulli loss probability per payload
    latency_s: float = 0.0  # base one-way latency
    jitter_s: float = 0.0  # uniform [0, jitter_s) added per payload
    bandwidth_bps: float = math.inf  # bytes/second on the wire

    def delivery_time(
        self,
        rng,
        nbytes: int,
        *,
        contended_bytes: float | None = None,
        backhaul_bps: float = math.inf,
    ) -> float:
        """Simulated arrival time of an nbytes payload; inf if lost.

        With a finite shared ``backhaul_bps``, ``contended_bytes`` is the sum
        of ALL bytes concurrently on the backhaul (this payload included): the
        wire term becomes ``max(own/bandwidth, contended/backhaul)`` — the
        transfer is pinned by whichever is slower, its own last-mile link or
        its fair share of the serialized backhaul.  The defaults reproduce
        the uncontended per-payload time bit-for-bit.
        """
        if rng.random() < self.drop:
            return math.inf
        jitter = rng.random() * self.jitter_s if self.jitter_s else 0.0
        wire = nbytes / self.bandwidth_bps
        if contended_bytes is not None:
            wire = max(wire, contended_bytes / backhaul_bps)
        return self.latency_s + jitter + wire


@dataclass
class LinkScenario(Scenario):
    """Per-client links against a straggler deadline.

    ``payload_bytes`` maps kind -> exact wire bytes of that payload (from
    ``wire.serialized_size``); the transport wires this up so codec choice
    changes who straggles — e.g. dense float32 W_RF misses a tight deadline
    that the seed-replay key makes trivially.

    A finite ``backhaul_bps`` models a shared uplink (cell tower / institute
    egress): every payload of a round contends with all the others attempting
    the same kind concurrently, so each client's wire time is driven by the
    *sum* of in-flight bytes, not its own payload alone — K clients on a
    shared pipe straggle together even when each last-mile link is fast.
    ``backhaul_bps = inf`` (default) keeps the seed's per-payload behavior
    bit-for-bit, rng stream included.

    The fedsim async runtime does not use round plans; it queries
    :meth:`uplink_outcome` per dispatched client instead (lost payloads
    retransmitted under exponential backoff with jitter, contention from the
    bytes currently in flight), so a client's arrival time — and therefore
    its staleness at consumption — follows from the exact wire bytes of the
    configured codec.  After ``max_retries`` failed attempts the client gives
    up and the uplink is reported as a drop (``delivered=False`` /
    ``uplink_time() == inf``), never an exception and never an unbounded
    spin as ``drop → 1``.
    """

    links: list[LinkModel]
    deadline_s: float = math.inf
    payload_bytes: dict[str, int] = field(default_factory=dict)
    backhaul_bps: float = math.inf  # shared-uplink capacity (queueing)
    retry_s: float = 1.0  # initial retransmit backoff for lost async uplinks
    max_retries: int = 8  # give up (report drop) after this many retransmits
    backoff: float = 2.0  # exponential backoff factor per retransmit
    retry_jitter: float = 0.5  # +- fraction of uniform jitter on each wait

    def plan(self, rng, n_clients, t) -> RoundPlan:
        if len(self.links) < n_clients:
            raise ValueError(f"{len(self.links)} links for {n_clients} clients")
        contended = math.isfinite(self.backhaul_bps)
        sets: dict[str, list[int]] = {"moments": [], "w_rf": [], "classifier": []}
        for i in range(n_clients):
            for kind in sets:
                nbytes = self.payload_bytes.get(kind, 0)
                # all n_clients attempt this kind's payload concurrently; lost
                # ones still occupied airtime, so contention counts them all
                dt = self.links[i].delivery_time(
                    rng,
                    nbytes,
                    contended_bytes=(n_clients * nbytes) if contended else None,
                    backhaul_bps=self.backhaul_bps,
                )
                if dt <= self.deadline_s:
                    sets[kind].append(i)
        return _nest(sets["moments"], sets["w_rf"], sets["classifier"])

    def total_uplink_bytes(self, kinds: tuple[str, ...] = ("moments", "w_rf")) -> int:
        """Exact wire bytes of one client uplink carrying ``kinds``."""
        return sum(self.payload_bytes.get(kind, 0) for kind in kinds)

    def uplink_outcome(
        self,
        rng,
        client: int,
        nbytes: int,
        *,
        inflight_bytes: float = 0.0,
    ) -> tuple[bool, float]:
        """One client uplink attempt sequence -> ``(delivered, elapsed_s)``.

        Bernoulli losses are retransmitted under exponential backoff with
        jitter: attempt ``a`` waits ``retry_s * backoff**a`` (times a uniform
        ``1 ± retry_jitter`` factor) before trying again.  After
        ``max_retries`` retransmits the client gives up: ``(False, elapsed)``
        where ``elapsed`` is the virtual time burned backing off — the
        caller needs it to schedule what happens next (re-dispatch, drop
        accounting).  On success ``elapsed`` includes latency, jitter and the
        (possibly backhaul-contended) wire time.  ``drop=0`` draws no retry
        randomness, keeping fault-free rng streams bit-identical to the seed.
        """
        reg = get_registry()
        link = self.links[client]
        t = 0.0
        if link.drop:
            for attempt in range(self.max_retries + 1):
                if rng.random() >= link.drop:
                    break
                if attempt == self.max_retries:
                    reg.counter("net.giveups").inc(client=client)
                    return False, t  # budget exhausted: no wait after last try
                reg.counter("net.retries").inc(client=client)
                wait = self.retry_s * (self.backoff**attempt)
                if self.retry_jitter:
                    wait *= 1.0 + self.retry_jitter * (2.0 * rng.random() - 1.0)
                t += wait
        jitter = rng.random() * link.jitter_s if link.jitter_s else 0.0
        wire = nbytes / link.bandwidth_bps
        if math.isfinite(self.backhaul_bps):
            wire = max(wire, (nbytes + inflight_bytes) / self.backhaul_bps)
        elapsed = t + link.latency_s + jitter + wire
        reg.histogram("net.uplink_s").observe(elapsed, client=client)
        return True, elapsed

    def uplink_time(
        self,
        rng,
        client: int,
        nbytes: int,
        *,
        inflight_bytes: float = 0.0,
    ) -> float:
        """Virtual seconds until a client's nbytes uplink lands at the server;
        ``inf`` when the retry budget is exhausted (give-up == drop)."""
        delivered, t = self.uplink_outcome(
            rng, client, nbytes, inflight_bytes=inflight_bytes
        )
        return t if delivered else math.inf


@dataclass
class CorruptionScenario(Scenario):
    """Per-kind payload corruption as an erasure channel over ``base``.

    With CRC32 envelope checksums every corrupted frame is rejected and
    retransmitted; a payload only *disappears* when all ``1 + max_retries``
    attempts corrupt, i.e. with probability ``rate ** (1 + max_retries)``.
    This wrapper removes exactly those clients from the base plan's
    per-kind sets — corruption under a working defense degrades to (rare)
    loss, which the protocol already tolerates.  ``rates`` maps payload
    kind (``moments`` / ``w_rf`` / ``classifier``) to the per-frame
    corruption probability.  Zero rates replay the base scenario exactly,
    rng stream included.
    """

    base: Scenario
    rates: dict[str, float] = field(default_factory=dict)
    max_retries: int = 8

    def plan(self, rng, n_clients, t) -> RoundPlan:
        p = self.base.plan(rng, n_clients, t)

        def survive(ids: list[int], kind: str) -> list[int]:
            rate = self.rates.get(kind, 0.0)
            if rate <= 0.0:
                return list(ids)
            giveup = rate ** (1 + self.max_retries)
            return [i for i in ids if rng.random() >= giveup]

        return _nest(
            survive(p.msg_clients, "moments"),
            survive(p.w_clients, "w_rf"),
            survive(p.c_clients, "classifier"),
        )


def amortized_interval_bytes(nbytes: int, interval: int) -> float:
    """Expected per-uplink byte share of an interval payload.

    The classifier syncs every T_C-th aggregation (Table II), so a single
    uplink cannot know whether *its* consuming flush will carry the
    classifier payload.  In expectation each uplink pays ``nbytes / T_C`` of
    it, and that share belongs in :meth:`LinkScenario.uplink_time`'s byte
    argument — otherwise the T_C-interval payload crosses the wire for free
    and never contends for the shared backhaul.  The fedsim schedulers add
    this to every uplink's wire bytes (exact in expectation, smooth in time —
    the alternative, spiking every T_C-th uplink, would need the dispatch to
    predict flush parity, which the buffered server does not know)."""
    if interval <= 0:
        raise ValueError(f"interval must be >= 1, got {interval}")
    return nbytes / interval


@dataclass
class TraceScenario(Scenario):
    """Deterministic replay of an explicit plan list (cycled if ``cycle``)."""

    plans: list[RoundPlan]
    cycle: bool = False

    def plan(self, rng, n_clients, t) -> RoundPlan:
        # round() is called with t starting at 1 (protocol convention)
        idx = t - 1
        if self.cycle:
            idx %= len(self.plans)
        if not 0 <= idx < len(self.plans):
            raise IndexError(f"trace has {len(self.plans)} rounds, asked for t={t}")
        return self.plans[idx]


def record_trace(
    scenario: Scenario, rng: np.random.Generator, n_clients: int, rounds: int
) -> TraceScenario:
    """Materialize any scenario into a replayable trace."""
    return TraceScenario([scenario.plan(rng, n_clients, t) for t in range(1, rounds + 1)])


def save_trace(trace: TraceScenario, path) -> None:
    with open(path, "w") as f:
        json.dump(
            [
                {"msg": p.msg_clients, "w": p.w_clients, "c": p.c_clients}
                for p in trace.plans
            ],
            f,
        )


def load_trace(path, *, cycle: bool = False) -> TraceScenario:
    with open(path) as f:
        raw = json.load(f)
    return TraceScenario(
        [RoundPlan(list(p["msg"]), list(p["w"]), list(p["c"])) for p in raw], cycle
    )


def table3_trace(setting: str, n_clients: int, rounds: int, seed: int = 0) -> TraceScenario:
    """Table III settings (I)/(II)/(III) expressed as deterministic traces."""
    return record_trace(
        TableIIIScenario(setting), np.random.default_rng(seed), n_clients, rounds
    )
