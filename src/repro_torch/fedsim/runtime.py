"""Event-driven federated runtime: virtual-time schedulers over the trainer.

Port of ``repro.fedsim.runtime`` over the port's ``FedRFTCATrainer``.  The
host side is the reference's: the same numpy stream
(``default_rng((proto.seed, seed, 0xF5ED))``), the same event order, so event
times, flush members, staleness and weights come out equal to the
reference's.  The flush runs on the trainer's device: the buffered rows'
dispatch-time draws are stacked on the host and copied once per flush, and
``BatchedRoundEngine.flush`` runs the merges there (K9 with a topology, K10
under the qint codecs).  A dispatch's downlink is keyed ``(0x00A5, d)``
(``BatchedRoundEngine.channel_uniforms``), a flush's by its index f.

The fixed round loop of ``FedRFTCATrainer.train`` advances in lockstep — the
only "network" it ever sees is which uplinks a round plan drops.  This module
replaces the loop with a discrete-event simulation (``fedsim.clock``) in
which *time itself* comes from the communication subsystem: a client's update
lands when ``comm.netsim`` says its exact wire bytes have crossed its link,
clients churn on an ``fedsim.availability`` trace, and the server either
waits for everyone (:class:`SyncScheduler`) or aggregates a buffer of
whatever arrived (:class:`AsyncScheduler`).

Two schedulers, one API (``run(n, eval_every) -> history``):

- :class:`SyncScheduler` — barrier per round.  The plan comes from the
  trainer's scenario intersected with the availability trace at the barrier's
  virtual time (offline clients are dropped — the "naive drop-the-stragglers"
  baseline), and the round executes through the ``run_round`` hook, so with
  no churn the trajectory is exactly ``trainer.train()``'s.
- :class:`AsyncScheduler` — FedBuff-style buffered aggregation.  Clients are
  dispatched with the target's current Sigma-ell broadcast, train at their
  own pace, and their uplinks land whenever the link model delivers them; the
  server flushes the buffer every ``buffer_size`` arrivals, weighting each
  update's moment / W_RF / classifier contribution by its staleness
  (``federated.aggregation.staleness_weights``: constant | polynomial |
  auto).  With uniform latencies, no churn and ``buffer_size = K`` every
  flush is a full buffer at staleness 0 and the trajectory degenerates to
  the sync engine's (pinned <= 1e-6 by the tests on the CPU).

Because arrival times follow from exact wire bytes, the *codec* choice
changes arrival order and therefore staleness — the comm subsystem feeds
back into the learning dynamics instead of only into byte accounting.  The
T_C-interval classifier payload is amortized into every uplink's wire bytes
(``netsim.amortized_interval_bytes``), so interval syncs count toward wire
time and backhaul contention too.

Fault plane (the robustness layer): uplinks now ride
``netsim.uplink_outcome`` — a retry budget with exponential backoff instead
of an unbounded retransmit loop — so a hopeless link *gives up*
(:class:`UplinkGaveUp`) and the client re-dispatches fresh.  Scheduled
:class:`ServerCrashed` events restore the trainer's last checkpoint
(``checkpoint/ckpt.py`` via ``FedRFTCATrainer.save_state`` /
``restore_state``, written every ``AsyncConfig.checkpoint_interval_s``
virtual seconds) and replay deterministically; :class:`EdgeCrashed` events
lose one edge's buffer and in-flight backhaul uplinks without touching
server state.

Fleet scale: when the trainer carries a ``repro_torch.fleet.Topology``, the
:class:`AsyncScheduler` keeps one buffer *per edge* — an edge flushes when
its own buffer fills, merges it, and (with ``edge_links``) ships one uplink
across the backhaul; the server flush fires when that merged uplink lands
(:class:`EdgeUplinkArrived`).  ``AsyncConfig.eval_interval`` adds
time-triggered :class:`EvalTick` events for dense accuracy-vs-virtual-time
curves independent of the flush schedule.
"""
from __future__ import annotations

import math
import tempfile
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.comm import wire
from repro_torch.comm.netsim import LinkScenario, amortized_interval_bytes
from repro_torch.federated import aggregation
from repro_torch.federated.network import RoundPlan
from repro_torch.fedsim.availability import AvailabilityTrace
from repro_torch.fedsim.clock import EventQueue, VirtualClock
from repro_torch.fedsim.events import (
    ClientDeparted,
    ClientJoined,
    ClientUpdateArrived,
    EdgeCrashed,
    EdgeUplinkArrived,
    EvalTick,
    ServerCrashed,
    SyncBarrier,
    UplinkGaveUp,
)
from repro_torch.obs.records import CrashRecord, EvalRecord, FlushRecord, RoundRecord


def _per_client(value, k: int, what: str) -> np.ndarray:
    arr = np.full((k,), float(value)) if np.ndim(value) == 0 else np.asarray(value, float)
    if arr.shape != (k,):
        raise ValueError(f"{what} must be a scalar or length-{k} sequence")
    if (arr < 0).any():
        raise ValueError(f"{what} must be >= 0")
    return arr


class _SchedulerBase:
    """Shared plumbing: virtual clock, per-client compute times, link wiring.

    Telemetry: when a global :class:`repro_torch.obs.Tracer` is installed
    (``obs.use_tracer()``), both schedulers emit their episodes — sync
    rounds; async compute / uplink / flush / crash / recovery /
    checkpoint — as spans on the *virtual-time* track, keyed to the
    VirtualClock (client ``i`` on lane ``tid=i+1``, the server on
    ``tid=0``, edge backhauls above the client lanes), so an exported
    Chrome trace reconstructs the whole timeline.  Metrics go to the
    active ``obs`` registry; both default to no-ops.
    """

    @property
    def tracer(self):
        # resolved per use so ``obs.use_tracer()`` around run() works even
        # when the scheduler was constructed outside the context
        return obs.get_tracer()

    def __init__(self, trainer, *, availability, links, compute_s, seed):
        self.trainer = trainer
        self.clock = VirtualClock()
        self.queue = EventQueue()
        self.availability = availability
        self.links = links
        self.compute_s = _per_client(compute_s, trainer.k, "compute_s")
        # wire/compute randomness is a separate stream from the trainer's plan
        # rng — the schedulers must not perturb the scenario draws that make a
        # no-churn SyncScheduler reproduce trainer.train() exactly
        self.rng = np.random.default_rng((trainer.proto.seed, seed, 0xF5ED))
        self.history: list[dict[str, Any]] = []
        if availability is not None and availability.n_clients < trainer.k:
            raise ValueError(
                f"availability trace covers {availability.n_clients} clients, "
                f"trainer has {trainer.k}"
            )
        self.payload_bytes: dict[str, int] = {}
        if links is not None:
            if len(links.links) < trainer.k:
                raise ValueError(f"{len(links.links)} links for {trainer.k} clients")
            # the loop-closing default: arrival times follow the exact wire
            # bytes of THIS trainer's configured codecs.  Kept scheduler-local
            # (the caller's scenario object is never mutated, so one
            # LinkScenario can serve trainers with different codecs).
            self.payload_bytes = dict(links.payload_bytes) or trainer.transport.payload_sizes(
                trainer._specs
            )

    def _uplink_kinds(self) -> tuple[str, ...]:
        proto, kinds = self.trainer.proto, []
        if proto.exchange_messages:
            kinds.append("moments")
        if proto.aggregate_w_rf and not self.trainer._frozen_w:
            kinds.append("w_rf")
        return tuple(kinds)

    def _uplink_nbytes(self) -> float:
        """Wire bytes of one client uplink: the per-round payloads plus the
        expected per-flush share of the T_C-interval classifier sync — so
        interval payloads count toward wire time and backhaul contention."""
        proto = self.trainer.proto
        nbytes = float(sum(self.payload_bytes.get(k, 0) for k in self._uplink_kinds()))
        if proto.aggregate_classifier:
            nbytes += amortized_interval_bytes(
                self.payload_bytes.get("classifier", 0), proto.t_c
            )
        return nbytes

    def _edge_uplink_nbytes(self) -> float:
        """Exact wire bytes of one merged edge -> server uplink: the partial
        merges + masses at the tier-2 codec, with the classifier partial's
        T_C-amortized share.  Shared by both schedulers: the async backhaul
        events and the sync barrier's per-edge leg price the same frame."""
        tr = self.trainer
        nbytes = sum(
            wire.serialized_size(k, tr._edge_specs[k], tr.edge_transport.codecs[k])
            for k in self._uplink_kinds()
        )
        if tr.proto.aggregate_classifier:
            nbytes += amortized_interval_bytes(
                wire.serialized_size(
                    "classifier",
                    tr._edge_specs["classifier"],
                    tr.edge_transport.codecs["classifier"],
                ),
                tr.proto.t_c,
            )
        return nbytes


@dataclass
class AsyncConfig:
    """Knobs of the buffered-asynchronous server.

    ``buffer_size`` is per buffer: the server's single buffer in the flat
    plane, each *edge's* buffer when the trainer carries a fleet topology
    (edges flush their own buffers).  ``eval_interval`` adds time-triggered
    :class:`EvalTick` events every that-many virtual seconds, so
    accuracy-vs-virtual-time curves are dense instead of flush-aligned.

    Fault plane: ``server_crash_times`` / ``edge_crash_times`` schedule
    :class:`ServerCrashed` / :class:`EdgeCrashed` events at fixed virtual
    times (edge crashes are ``(time, edge)`` pairs).  A server crash restores
    the last checkpoint — written every ``checkpoint_interval_s`` virtual
    seconds (flush-aligned) into ``ckpt_dir`` (a temp dir when None) — and
    re-dispatches the live cohort after ``restart_delay_s``; replay from the
    checkpoint is deterministic, so two identical runs stay bitwise equal.
    """

    buffer_size: int = 2
    staleness: str = "constant"  # constant | polynomial[:alpha] | auto
    compute_s: Any = 1.0  # per-client local-training seconds (scalar or (K,))
    eval_interval: float | None = None  # virtual seconds between EvalTicks
    seed: int = 0
    # -- fault plane --------------------------------------------------------
    server_crash_times: tuple = ()  # virtual times of ServerCrashed events
    edge_crash_times: tuple = ()  # (time, edge) pairs of EdgeCrashed events
    restart_delay_s: float = 1.0  # crash -> first re-dispatch delay
    checkpoint_interval_s: float | None = None  # virtual s between checkpoints
    ckpt_dir: str | None = None  # checkpoint directory (temp dir when None)


class SyncScheduler(_SchedulerBase):
    """Barrier-per-round scheduler: the existing protocol on a virtual clock.

    Each round: draw the plan from the trainer's scenario (same rng stream as
    ``trainer.train()``), drop clients the availability trace says are offline
    at the barrier — stragglers and churned clients are simply *lost* for the
    round, the paper's Table III worldview — execute via the ``run_round``
    hook, then advance the clock to the barrier: the deadline if a link
    scenario enforces one, else the slowest participant's completion, else
    ``round_s``.

    With ``edge_links`` (two-tier topologies), each active edge adds an
    explicit backhaul leg: the edge forwards its merged round payload to the
    server only after its slowest member completes, so the barrier is
    ``max over edges (slowest member + edge uplink)`` — previously the
    backhaul was silently folded into client links only.
    """

    def __init__(
        self,
        trainer,
        *,
        availability: AvailabilityTrace | None = None,
        links: LinkScenario | None = None,
        edge_links: LinkScenario | None = None,
        round_s: float = 1.0,
        compute_s: Any = 1.0,
        seed: int = 0,
    ):
        super().__init__(
            trainer, availability=availability, links=links, compute_s=compute_s, seed=seed
        )
        if edge_links is not None:
            if trainer.topology is None:
                raise ValueError("edge_links need a fleet topology on the trainer")
            if len(edge_links.links) < trainer.topology.n_edges:
                raise ValueError(
                    f"{len(edge_links.links)} edge links for "
                    f"{trainer.topology.n_edges} edges"
                )
        self.edge_links = edge_links
        self.round_s = float(round_s)

    def _round_duration(self, plan: RoundPlan) -> float:
        if self.links is None and self.edge_links is None:
            return self.round_s
        if self.links is not None and np.isfinite(self.links.deadline_s):
            return float(self.links.deadline_s)  # the barrier waits out the deadline
        nbytes = self._uplink_nbytes() if self.links is not None else 0.0
        # a gave-up uplink (inf) is a straggler LOST to the round, not one
        # the barrier waits forever for
        done: dict[int, float] = {}
        for i in plan.msg_clients:
            t = self.compute_s[i] + (
                self.links.uplink_time(self.rng, i, nbytes)
                if self.links is not None
                else 0.0
            )
            if math.isfinite(t):
                done[i] = t
        if self.edge_links is None:
            return max(done.values(), default=self.round_s)
        # explicit per-edge backhaul leg: each active edge forwards its merged
        # payload once its slowest surviving member lands; an edge whose
        # backhaul gives up (inf) loses the round like a straggler client
        topo = self.trainer.topology
        e_bytes = self._edge_uplink_nbytes()
        times = []
        for e in topo.edges_of(list(done)):
            slowest = max(done[i] for i in done if topo.edge_of(i) == e)
            leg = self.edge_links.uplink_time(self.rng, e, e_bytes)
            if math.isfinite(leg):
                times.append(slowest + leg)
        return max(times, default=self.round_s)

    def run(self, n_rounds: int, eval_every: int = 0) -> list[dict[str, Any]]:
        tr = self.trainer
        for t in range(1, n_rounds + 1):
            plan = tr.scenario.plan(tr.rng, tr.k, t)
            if self.availability is not None:
                online = set(self.availability.available_at(self.clock.now))
                plan = RoundPlan(
                    [i for i in plan.msg_clients if i in online],
                    [i for i in plan.w_clients if i in online],
                    [i for i in plan.c_clients if i in online],
                )
            start = self.clock.now
            tr.run_round(t, plan)
            self.queue.push(self.clock.now + self._round_duration(plan), SyncBarrier(t))
            barrier_t, _ = self.queue.pop()
            self.clock.advance_to(barrier_t)
            row = RoundRecord(
                t=self.clock.now, round=t, participants=len(plan.msg_clients)
            )
            if eval_every and t % eval_every == 0:
                row["acc"] = tr.evaluate()
            self.history.append(row)
            tracer = self.tracer
            if tracer is not None:
                tracer.begin(
                    "round", start, args={"round": t, "participants": row.participants}
                )
                tracer.end("round", self.clock.now)
            reg = obs.metrics()
            reg.counter("fedsim.rounds").inc()
            reg.histogram("fedsim.round_s").observe(self.clock.now - start)
        tr.flush_probes()  # drain the one-step probe pipeline
        return self.history


class AsyncScheduler(_SchedulerBase):
    """FedBuff-style buffered-asynchronous scheduler (see module docstring).

    Lifecycle per client: *dispatch* (draw batches, hand over the target's
    current broadcast, tag with the server model version) -> local compute
    (``compute_s`` virtual seconds) -> uplink (``links.uplink_time`` over the
    exact wire bytes, shared-backhaul contention included) ->
    :class:`ClientUpdateArrived`.  Every ``buffer_size`` arrivals the server
    flushes: one ``engine.flush`` call materializes the buffered
    clients' local steps, trains the target on their staleness-weighted
    moments, and merges W_RF (+ classifier every ``t_c``-th flush), then the
    consumed clients are re-dispatched.  Churn edges from the availability
    trace cancel in-flight work (departure bumps the client's epoch, orphaning
    its arrival event) and re-dispatch on rejoin from the client's *retained*
    — now stale — local parameters.
    """

    def __init__(
        self,
        trainer,
        cfg: AsyncConfig | None = None,
        *,
        availability: AvailabilityTrace | None = None,
        links: LinkScenario | None = None,
        edge_links: LinkScenario | None = None,
    ):
        cfg = cfg or AsyncConfig()
        if trainer._engine is None:
            raise ValueError("AsyncScheduler needs the batched engine (engine='batched')")
        topo = trainer.topology
        if topo is None:
            if not 1 <= cfg.buffer_size <= max(trainer.k, 1):
                raise ValueError(f"buffer_size must be in [1, K={trainer.k}]")
            if edge_links is not None:
                raise ValueError("edge_links need a fleet topology on the trainer")
        else:
            smallest = min(len(topo.members(e)) for e in range(topo.n_edges))
            if not 1 <= cfg.buffer_size <= smallest:
                raise ValueError(
                    f"buffer_size must be in [1, {smallest}] (smallest edge) "
                    f"for this topology"
                )
            if edge_links is not None and len(edge_links.links) < topo.n_edges:
                raise ValueError(
                    f"{len(edge_links.links)} edge links for {topo.n_edges} edges"
                )
        if cfg.eval_interval is not None and cfg.eval_interval <= 0:
            raise ValueError(f"eval_interval must be > 0, got {cfg.eval_interval}")
        if cfg.checkpoint_interval_s is not None and cfg.checkpoint_interval_s <= 0:
            raise ValueError(
                f"checkpoint_interval_s must be > 0, got {cfg.checkpoint_interval_s}"
            )
        if cfg.restart_delay_s < 0:
            raise ValueError(f"restart_delay_s must be >= 0, got {cfg.restart_delay_s}")
        n_edges = topo.n_edges if topo is not None else 1
        for item in cfg.edge_crash_times:
            ct, e = item
            if not 0 <= int(e) < n_edges:
                raise ValueError(f"edge crash {item}: edge id out of range [0, {n_edges})")
            if ct < 0:
                raise ValueError(f"edge crash {item}: time must be >= 0")
        if any(ct < 0 for ct in cfg.server_crash_times):
            raise ValueError(f"server crash times must be >= 0: {cfg.server_crash_times}")
        aggregation.staleness_weights(np.zeros(1), cfg.staleness)  # validate mode early
        super().__init__(
            trainer,
            availability=availability,
            links=links,
            compute_s=cfg.compute_s,
            seed=cfg.seed,
        )
        self.cfg = cfg
        self.version = 0  # server model version (== completed flushes)
        self.flushes = 0
        self.dispatches = 0
        self.live: set[int] = set()
        self.epoch = np.zeros(trainer.k, dtype=np.int64)
        self.pending: dict[int, dict] = {}  # client -> dispatch record (in flight)
        # one buffer per edge (the flat plane is the single pseudo-edge 0);
        # an edge flushes when ITS buffer fills, not the global arrival count
        self.topology = topo
        self._n_edges = topo.n_edges if topo is not None else 1
        self.buffers: dict[int, list[dict]] = {e: [] for e in range(self._n_edges)}
        self.edge_links = edge_links
        self._edge_seq = 0
        # seq -> (edge, merged entries): the edge id is kept so an EdgeCrashed
        # event can cancel that edge's in-flight backhaul uplinks
        self._edge_uplinks: dict[int, tuple[int, list[dict]]] = {}
        self._edge_inflight: list[tuple[float, float]] = []  # backhaul (finish, bytes)
        self._inflight: list[tuple[float, float]] = []  # (finish_time, bytes) uplinks
        self._n_k = np.array([d.x.shape[1] for d in trainer.sources], dtype=np.int64)
        # -- fault plane: give-up accounting + crash/checkpoint state ---------
        self.giveups = 0  # uplinks lost to exhausted retry budgets
        self.recoveries: list[dict[str, Any]] = []  # one row per server recovery
        self._ckpt_dir = cfg.ckpt_dir
        self._ckpt_meta: dict[str, Any] | None = None  # {"t", "flushes"} of last ckpt
        self._next_ckpt: float | None = None

    def _edge_of(self, client: int) -> int:
        return self.topology.edge_of(client) if self.topology is not None else 0

    # -- client lifecycle ---------------------------------------------------

    def _dispatch(self, clients, t: float) -> None:
        """Start one local-training task per client, sharing a single target
        broadcast (one downlink per dispatch instant, like the sync round)."""
        tr = self.trainer
        clients = sorted(c for c in clients if c in self.live)
        if not clients:
            return
        self.dispatches += 1
        chan_key = (0x00A5, self.dispatches) if tr._engine.channel else None
        tgt_msg = tr.target_message(chan_key=chan_key)  # (2N,) on the trainer's device
        if tr.proto.exchange_messages:
            tr.transport.account_spec("moments", tr._specs["moments"], count=1)
        tracer = self.tracer
        reg = obs.metrics()
        reg.counter("fedsim.dispatches").inc()
        for i in clients:
            xs, ys, x_msg = tr.draw_client_dispatch(i)
            self.pending[i] = {
                "client": i,
                "version": self.version,
                "xs": xs,
                "ys": ys,
                "x_msg": x_msg,
                "tgt_msg": tgt_msg,
            }
            delivered, delay = self._completion_delay(i, t)
            reg.counter("fedsim.client_dispatches").inc(client=i)
            if tracer is not None:
                compute = float(self.compute_s[i])
                tracer.complete(
                    "compute", t, compute, tid=i + 1,
                    args={"client": i, "version": self.version},
                )
                tracer.complete(
                    "uplink" if delivered else "uplink_giveup",
                    t + compute, delay - compute, tid=i + 1, args={"client": i},
                )
            ev = (
                ClientUpdateArrived(i, self.version, int(self.epoch[i]), t)
                if delivered
                else UplinkGaveUp(i, self.version, int(self.epoch[i]), t)
            )
            self.queue.push(t + delay, ev)

    def _completion_delay(self, i: int, t: float) -> tuple[bool, float]:
        """(delivered, compute + wire seconds).  ``delivered=False`` means the
        link exhausted its retry budget (``netsim.uplink_outcome`` give-up):
        the update is lost at the returned elapsed time and the scheduler will
        re-dispatch the client instead of retransmitting forever."""
        compute = float(self.compute_s[i])
        if self.links is None:
            return True, compute
        start = t + compute
        self._inflight = [(fin, b) for fin, b in self._inflight if fin > start]
        inflight_bytes = sum(b for _, b in self._inflight)
        nbytes = self._uplink_nbytes()
        delivered, wire = self.links.uplink_outcome(
            self.rng, i, nbytes, inflight_bytes=inflight_bytes
        )
        if delivered:
            self._inflight.append((start + wire, nbytes))
        return delivered, compute + wire

    def _on_arrival(self, t: float, ev: ClientUpdateArrived) -> int | None:
        """Buffer the update at the client's edge; return the edge id when
        its buffer just filled (None otherwise)."""
        if ev.epoch != self.epoch[ev.client] or ev.client not in self.live:
            obs.metrics().counter("fedsim.orphaned_arrivals").inc()
            return None  # churned away mid-flight: the update is lost
        entry = self.pending.pop(ev.client, None)
        if entry is None or entry["version"] != ev.version:
            return None  # superseded dispatch (defensive; churn covers this)
        obs.metrics().counter("fedsim.arrivals").inc()
        if self.trainer.proto.exchange_messages:
            self.trainer.transport.account_spec(
                "moments", self.trainer._specs["moments"], count=1
            )
        edge = self._edge_of(ev.client)
        buf = self.buffers[edge]
        # a rejoin can race an unconsumed buffered update: newest wins
        self.buffers[edge] = buf = [e for e in buf if e["client"] != ev.client]
        buf.append(entry)
        return edge if len(buf) >= self.cfg.buffer_size else None

    # -- the edge backhaul (two-tier topologies) ----------------------------
    # (_edge_uplink_nbytes lives on _SchedulerBase — shared with the sync
    # barrier's per-edge backhaul leg)

    def _edge_uplink_delay(self, edge: int, t: float) -> tuple[bool, float]:
        """(delivered, backhaul crossing seconds) of a merged edge uplink
        starting at ``t``, contended against the other edge uplinks in flight.
        ``delivered=False``: the backhaul gave up — the whole merged buffer is
        lost and its clients re-dispatch."""
        self._edge_inflight = [(fin, b) for fin, b in self._edge_inflight if fin > t]
        inflight = sum(b for _, b in self._edge_inflight)
        nbytes = self._edge_uplink_nbytes()
        delivered, delay = self.edge_links.uplink_outcome(
            self.rng, edge, nbytes, inflight_bytes=inflight
        )
        if delivered:
            self._edge_inflight.append((t + delay, nbytes))
        return delivered, delay

    # -- crash-restart: checkpoints + recovery ------------------------------

    @property
    def ckpt_dir(self) -> str:
        if self._ckpt_dir is None:
            self._ckpt_dir = tempfile.mkdtemp(prefix="fedsim_ckpt_")
        return self._ckpt_dir

    def _checkpoint(self, t: float) -> None:
        """Snapshot the full trainer state (arrays + host rng/iterator state,
        ``FedRFTCATrainer.save_state``) tagged with the flush count."""
        self.trainer.save_state(self.ckpt_dir, step=self.flushes)
        self._ckpt_meta = {"t": t, "flushes": self.flushes}
        obs.metrics().counter("fedsim.checkpoints").inc()
        if self.tracer is not None:
            self.tracer.instant("checkpoint", t, args={"flushes": self.flushes})

    def _maybe_checkpoint(self, t: float) -> None:
        if self._next_ckpt is None or t < self._next_ckpt:
            return
        self._checkpoint(t)
        self._next_ckpt = t + self.cfg.checkpoint_interval_s

    def _redispatch_later(self, clients, t: float) -> None:
        """Queue a fresh dispatch for ``clients`` after the restart delay.
        Reuses :class:`ClientJoined` — same grouping (one shared broadcast per
        instant) and the epoch bump orphans anything still in flight."""
        restart = t + self.cfg.restart_delay_s
        for i in sorted(set(clients)):
            self.queue.push(restart, ClientJoined(i))

    def _recover(self, t: float) -> None:
        """ServerCrashed: restore the last checkpoint and replay from it.

        The trainer's arrays, optimizer state, scenario rng, and batch-stream
        positions all rewind to the checkpoint (bitwise —
        ``restore_state``'s contract), the scheduler's version/flush counters
        roll back with them, and everything in flight is orphaned via an
        epoch bump.  Only virtual time and the comm ledger keep running: a
        crash costs wall-clock and bytes, never determinism.
        """
        if self._ckpt_meta is None:
            raise RuntimeError(
                "ServerCrashed before any checkpoint — run() writes one at "
                "t=0 when crash times are configured"
            )
        tr = self.trainer
        tr.restore_state(self.ckpt_dir)
        rollback = t - self._ckpt_meta["t"]
        self.version = self.flushes = self._ckpt_meta["flushes"]
        self.epoch += 1  # orphan every in-flight arrival/give-up
        self.pending.clear()
        self.buffers = {e: [] for e in range(self._n_edges)}
        self._edge_uplinks.clear()
        self._inflight.clear()
        self._edge_inflight.clear()
        row = CrashRecord(
            t=t, crash="server", restored_flush=self.flushes, rollback_s=rollback
        )
        self.recoveries.append(row)
        self.history.append(row)
        reg = obs.metrics()
        reg.counter("fedsim.server_crashes").inc()
        reg.histogram("fedsim.rollback_s").observe(rollback)
        if self.tracer is not None:
            self.tracer.instant("server_crash", t, args={"rollback_s": rollback})
            self.tracer.begin(
                "recovery", t, args={"restored_flush": self.flushes}
            )
            self.tracer.end("recovery", t + self.cfg.restart_delay_s)
        self._redispatch_later(self.live, t)

    def _crash_edge(self, t: float, edge: int) -> None:
        """EdgeCrashed: the edge's buffered updates and its merged uplinks on
        the backhaul are lost; the clients behind them re-dispatch.  Server
        state is intact, so no rollback."""
        lost = [e["client"] for e in self.buffers[edge]]
        self.buffers[edge] = []
        for seq, (e_id, entries) in list(self._edge_uplinks.items()):
            if e_id == edge:
                lost += [e["client"] for e in entries]
                del self._edge_uplinks[seq]
        self.history.append(CrashRecord(t=t, crash="edge", edge=edge, lost=sorted(lost)))
        obs.metrics().counter("fedsim.edge_crashes").inc(edge=edge)
        if self.tracer is not None:
            self.tracer.instant("edge_crash", t, args={"edge": edge, "lost": len(lost)})
        self._redispatch_later(lost, t)

    # -- the buffered flush -------------------------------------------------

    def _flush(self, t: float, entries: list[dict]) -> dict[str, Any]:
        tr = self.trainer
        members = [e["client"] for e in entries]
        staleness = np.array([self.version - e["version"] for e in entries])
        w_members = aggregation.staleness_weights(
            staleness, self.cfg.staleness, n_samples=self._n_k[members]
        )
        k = tr.k
        buf = np.zeros((k,), np.float32)
        wts = np.zeros((k,), np.float32)
        buf[members] = 1.0
        wts[members] = w_members
        # assemble the stacked batch: buffered rows carry their dispatch-time
        # draws; the rest are finite dummies (computed then discarded by the
        # buffer mask — zeros would hit the unit-norm NaN gradient at 0)
        filler = entries[0]
        L, p = tr.proto.local_steps, tr.sources[0].x.shape[0]
        xs = np.empty((L, k, p, tr._b_max), np.float32)
        ys = np.empty((L, k, tr._b_max), np.int64)
        x_msg = np.empty((k, p, tr._mb_max), np.float32)
        # the broadcasts stay on the device, one per dispatch: row i of
        # tgt_msgs gathers the one client i was handed
        order: dict[int, int] = {}
        bcasts, rows = [], np.empty((k,), np.int64)
        by_client = {e["client"]: e for e in entries}
        for i in range(k):
            e = by_client.get(i, filler)
            xs[:, i], ys[:, i], x_msg[i] = e["xs"], e["ys"], e["x_msg"]
            rows[i] = order.setdefault(id(e["tgt_msg"]), len(order))
            if rows[i] == len(bcasts):
                bcasts.append(e["tgt_msg"])
        dev = tr.device
        batch = {
            "xs": torch.as_tensor(xs, device=dev),
            "ys": torch.as_tensor(ys, device=dev),
            "x_msg": torch.as_tensor(x_msg, device=dev),
            "xt_steps": torch.as_tensor(tr.draw_target_steps(), device=dev),
            "tgt_msgs": torch.stack(bcasts)[torch.as_tensor(rows, device=dev)],
            "bmask": tr._bmask,
            "msg_mask": tr._msg_mask,
        }
        f = self.flushes + 1
        masks = {
            "buf": torch.as_tensor(buf, device=dev),
            "weights": torch.as_tensor(wts, device=dev),
            "do_clf": f % tr.proto.t_c == 0,
        }
        out = tr._engine.flush(
            tr._src_stack, tr._src_opt_stack, tr.tgt_params, tr.tgt_opt, batch, masks,
            chan_key=f,
        )
        tr._src_stack, tr._src_opt_stack, tr.tgt_params, tr.tgt_opt = out[:4]
        if tr._engine.probe:
            tr.stash_probes("flush", out[4])
        # host-side accounting, same message counts as the sync round body;
        # the ingress leg collapses to one merged uplink per active edge in
        # the two-tier plane (here: the one edge whose buffer flushed)
        if tr.proto.exchange_messages and members:
            tr.account_ingress("moments", members)
        if tr.proto.aggregate_w_rf and members:
            tr.transport.account_spec("w_rf", tr._specs["w_rf"], count=len(members) + 1)
            tr.account_ingress("w_rf", members)
        if tr.proto.aggregate_classifier and f % tr.proto.t_c == 0 and members:
            tr.transport.account_spec(
                "classifier", tr._specs["classifier"], count=len(members)
            )
            tr.account_ingress("classifier", members)
        tr.comm.rounds += 1
        self.flushes = f
        self.version += 1
        tr.model_version = self.version
        tr.client_versions[members] = self.version
        row = FlushRecord(
            t=t,
            flush=f,
            version=self.version,
            members=sorted(members),
            staleness=staleness.tolist(),
            weights=w_members.tolist(),
        )
        self.history.append(row)
        reg = obs.metrics()
        reg.counter("fedsim.flushes").inc()
        reg.histogram("fedsim.flush_members").observe(len(members))
        for s in row.staleness:
            reg.histogram("fedsim.staleness").observe(s)
        if self.tracer is not None:
            self.tracer.begin(
                "flush", t,
                args={"flush": f, "members": row.members, "staleness": row.staleness},
            )
            self.tracer.end("flush", t)
        return row

    # -- event loop ---------------------------------------------------------

    def _seed_events(self) -> None:
        tr = self.trainer
        if self.availability is None:
            for i in range(tr.k):
                self.queue.push(0.0, ClientJoined(i))
            return
        for i in range(tr.k):
            for time, is_join in self.availability.edges(i):
                self.queue.push(time, ClientJoined(i) if is_join else ClientDeparted(i))

    def run(self, n_flushes: int, eval_every: int = 0) -> list[dict[str, Any]]:
        """Run until ``n_flushes`` buffered aggregations completed (or the
        event queue drains — e.g. every client churned away for good)."""
        tr = self.trainer
        if tr.k == 0:
            raise ValueError("async runtime needs at least one source client")
        self._seed_events()
        if self.cfg.eval_interval is not None:
            self.queue.push(self.cfg.eval_interval, EvalTick(1))
        for ct in self.cfg.server_crash_times:
            self.queue.push(float(ct), ServerCrashed())
        for ct, e in self.cfg.edge_crash_times:
            self.queue.push(float(ct), EdgeCrashed(int(e)))
        if self.cfg.server_crash_times or self.cfg.checkpoint_interval_s is not None:
            self._checkpoint(0.0)  # a crash before the first interval rolls to t=0
            if self.cfg.checkpoint_interval_s is not None:
                self._next_ckpt = self.cfg.checkpoint_interval_s
        while self.queue and self.flushes < n_flushes:
            # same-instant events pop in push order; joins are grouped so
            # simultaneous (re)joins share one dispatch broadcast
            t = self.queue.peek_time()
            self.clock.advance_to(t)
            batch_events = []
            while self.queue and self.queue.peek_time() == t:
                batch_events.append(self.queue.pop()[1])
            joined: list[int] = []
            for ev in batch_events:
                if isinstance(ev, ServerCrashed):
                    # processed ahead of same-instant churn/give-ups: the
                    # epoch bump orphans them and _recover re-dispatches the
                    # whole live cohort anyway
                    self._recover(t)
                elif isinstance(ev, EdgeCrashed):
                    self._crash_edge(t, ev.edge)
                elif isinstance(ev, ClientDeparted):
                    self.live.discard(ev.client)
                    self.epoch[ev.client] += 1
                    self.pending.pop(ev.client, None)
                elif isinstance(ev, ClientJoined):
                    self.live.add(ev.client)
                    self.epoch[ev.client] += 1
                    joined.append(ev.client)
                elif isinstance(ev, UplinkGaveUp):
                    if ev.epoch != self.epoch[ev.client] or ev.client not in self.live:
                        continue  # churned/crashed away: already orphaned
                    entry = self.pending.get(ev.client)
                    if entry is None or entry["version"] != ev.version:
                        continue
                    del self.pending[ev.client]
                    self.giveups += 1
                    obs.metrics().counter("fedsim.giveups").inc(kind="uplink")
                    joined.append(ev.client)  # lost, not looping: dispatch fresh
            if joined:
                self._dispatch(dict.fromkeys(joined), t)
            for ev in batch_events:
                if isinstance(ev, EvalTick):
                    # model state only changes at flushes, so evaluating at
                    # the tick's own time is exact; keep ticking only while
                    # progress is still possible (else the chain would spin
                    # an otherwise-drained queue forever)
                    acc = tr.evaluate()
                    self.history.append(EvalRecord(t=t, eval=ev.index, acc=acc))
                    if self.tracer is not None:
                        self.tracer.instant("eval", t, args={"acc": float(acc)})
                    if self.queue or self.pending or self._edge_uplinks:
                        self.queue.push(
                            t + self.cfg.eval_interval, EvalTick(ev.index + 1)
                        )
                    continue
                ready: list[dict] | None = None
                if isinstance(ev, ClientUpdateArrived):
                    edge = self._on_arrival(t, ev)
                    if edge is None:
                        continue
                    entries, self.buffers[edge] = self.buffers[edge], []
                    if self.edge_links is None:
                        ready = entries  # edge is colocated: flush immediately
                    else:
                        # the edge merges its buffer and ships ONE uplink;
                        # the server flushes when it crosses the backhaul
                        delivered, delay = self._edge_uplink_delay(edge, t)
                        if self.tracer is not None:
                            self.tracer.complete(
                                "edge_uplink" if delivered else "edge_uplink_giveup",
                                t, delay, tid=tr.k + 1 + edge, args={"edge": edge},
                            )
                        if delivered:
                            self._edge_seq += 1
                            self._edge_uplinks[self._edge_seq] = (edge, entries)
                            self.queue.push(
                                t + delay, EdgeUplinkArrived(edge, self._edge_seq)
                            )
                        else:
                            # backhaul gave up: the merged buffer is lost and
                            # its clients re-dispatch at the give-up instant
                            self.giveups += 1
                            obs.metrics().counter("fedsim.giveups").inc(kind="backhaul")
                            for i in sorted({e["client"] for e in entries}):
                                self.queue.push(t + delay, ClientJoined(i))
                        continue
                elif isinstance(ev, EdgeUplinkArrived):
                    item = self._edge_uplinks.pop(ev.seq, None)
                    if item is None:
                        continue  # orphaned by an edge/server crash
                    ready = item[1]
                if ready is None:
                    continue
                row = self._flush(t, ready)
                self._maybe_checkpoint(t)
                if eval_every and self.flushes % eval_every == 0:
                    row["acc"] = tr.evaluate()
                if self.flushes >= n_flushes:
                    break
                self._dispatch(row["members"], t)
        tr.flush_probes()  # drain the one-step probe pipeline
        return self.history
