"""Typed events driving the fedsim runtime.  A copy of ``repro.fedsim.events``.

Four event kinds cover the whole asynchronous protocol:

- :class:`ClientJoined` / :class:`ClientDeparted` — churn edges from an
  :mod:`repro_torch.fedsim.availability` trace.  A departure cancels the client's
  in-flight work (its ``epoch`` counter bumps, orphaning any scheduled
  arrival); a (re)join dispatches the client fresh from its *retained* local
  parameters — a returning client carries a stale aligner by construction.
- :class:`ClientUpdateArrived` — the client's uplink (Sigma-ell moments +
  W_RF, classifier piggybacked on T_C flushes) lands at the server at the
  virtual time ``comm.netsim`` computed from its exact wire bytes.  Carries
  the server model version the client was dispatched from, so the consumer
  can compute staleness = version_now - version_at_dispatch.
- :class:`SyncBarrier` — the synchronous scheduler's per-round rendezvous.
- :class:`EdgeUplinkArrived` — two-tier topologies only: an edge whose buffer
  filled merged it and shipped ONE uplink over the backhaul
  (``edge_links``); the server flushes when it lands, not when the edge
  filled.  ``seq`` keys the scheduler's in-flight table holding the merged
  entries.
- :class:`EvalTick` — time-triggered evaluation (``AsyncConfig.
  eval_interval``): accuracy-vs-virtual-time curves get points at a fixed
  cadence instead of only at flush boundaries.

Fault-plane events (the robustness layer):

- :class:`UplinkGaveUp` — ``netsim.uplink_outcome`` exhausted its retry
  budget: the client's update is *lost* (a reported drop, not an infinite
  retransmit loop) and the scheduler re-dispatches it fresh.  Carries the
  same (version, epoch) tags as an arrival so a churned/superseded give-up
  is orphaned identically.
- :class:`ServerCrashed` — the server process dies at a scheduled virtual
  time.  The scheduler restores the last checkpoint
  (``FedRFTCATrainer.restore_state``), rolls its version/flush counters back
  to the checkpoint's, orphans everything in flight, and re-dispatches the
  live cohort after ``restart_delay_s`` — replay from there is
  deterministic.
- :class:`EdgeCrashed` — one edge aggregator dies: its buffered updates and
  any merged uplink it has on the backhaul are lost; the affected clients
  re-dispatch after the restart delay.  No server state is lost, so no
  rollback.

Events hold only host-side bookkeeping (ints/floats); array payloads stay in
the scheduler's pending tables so the heap never compares tensors.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Event:
    """Marker base class (events are ordered by the queue, never by value)."""


@dataclass(frozen=True)
class ClientJoined(Event):
    client: int


@dataclass(frozen=True)
class ClientDeparted(Event):
    client: int


@dataclass(frozen=True)
class ClientUpdateArrived(Event):
    client: int
    version: int  # server model version the client was dispatched from
    epoch: int  # client availability epoch at dispatch (stale if it departed)
    dispatched_at: float  # virtual dispatch time (for latency bookkeeping)


@dataclass(frozen=True)
class SyncBarrier(Event):
    round: int


@dataclass(frozen=True)
class EdgeUplinkArrived(Event):
    edge: int
    seq: int  # key into the scheduler's in-flight edge-uplink table


@dataclass(frozen=True)
class EvalTick(Event):
    index: int


@dataclass(frozen=True)
class RequestArrived(Event):
    """Serving plane (the reference's ``repro.serve``, not ported yet): one
    inference/transform request of an open-loop arrival process lands at the
    aligner server.  ``request`` keys
    the load generator's request table (arrays stay host-side, as always).
    ``trace_id`` is the request's distributed-tracing id when head-sampled
    (``-1`` = not traced), so the event stream alone links to span trees."""

    request: int
    trace_id: int = -1


@dataclass(frozen=True)
class RequestCompleted(Event):
    """Serving plane: the batched dispatch holding ``request`` finished at
    this virtual time — per-request latency is completion minus arrival.
    ``trace_id`` mirrors the arrival's sampling decision (``-1`` untraced)."""

    request: int
    trace_id: int = -1


@dataclass(frozen=True)
class UplinkGaveUp(Event):
    client: int
    version: int  # server model version the client was dispatched from
    epoch: int  # availability epoch at dispatch (orphaned on mismatch)
    dispatched_at: float


@dataclass(frozen=True)
class ServerCrashed(Event):
    """Scheduled server failure: restore last checkpoint, replay."""


@dataclass(frozen=True)
class EdgeCrashed(Event):
    """Scheduled edge-aggregator failure: its buffer + backhaul uplink lost."""

    edge: int
