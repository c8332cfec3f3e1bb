"""repro_torch.fedsim — event-driven asynchronous federated runtime.

Port of ``repro.fedsim``: the same exports, over the port's trainer.

Discrete-event simulation over the FedRF-TCA trainer: a virtual clock and a
deterministic event heap (``clock``), typed churn/arrival/barrier events
(``events``), replayable client-availability traces (``availability``), and
two schedulers sharing one API (``runtime``): the barrier-per-round
:class:`SyncScheduler` (degenerates to ``trainer.train()`` with no churn) and
the FedBuff-style :class:`AsyncScheduler` with staleness-aware buffered
aggregation, whose arrival times come from ``comm.netsim``'s exact wire
bytes — codec choice changes staleness changes learning dynamics.
"""
from repro_torch.fedsim.availability import (
    AvailabilityTrace,
    always_on_trace,
    duty_cycle_trace,
    load_trace,
    markov_trace,
    save_trace,
)
from repro_torch.fedsim.clock import EventQueue, VirtualClock
from repro_torch.fedsim.events import (
    ClientDeparted,
    ClientJoined,
    ClientUpdateArrived,
    EdgeCrashed,
    EdgeUplinkArrived,
    EvalTick,
    Event,
    ServerCrashed,
    SyncBarrier,
    UplinkGaveUp,
)
from repro_torch.fedsim.runtime import AsyncConfig, AsyncScheduler, SyncScheduler
