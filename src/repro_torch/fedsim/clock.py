"""Virtual time + deterministic event heap for the fedsim runtime.  A copy of
``repro.fedsim.clock``.

Discrete-event simulation needs exactly two primitives: a clock that only
moves when an event fires (:class:`VirtualClock`) and a priority queue that
pops events in a *reproducible* order (:class:`EventQueue`).  Reproducibility
is the whole point — two events scheduled for the same virtual instant must
pop in the order they were pushed, on every machine, so the heap is keyed by
``(time, seq)`` where ``seq`` is a monotone push counter.  Event payloads are
never compared (dataclass events need no ordering methods).
"""
from __future__ import annotations

import heapq
from typing import Any


class VirtualClock:
    """Simulation time.  Monotone: ``advance_to`` rejects travel backwards."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance_to(self, t: float) -> float:
        if t < self.now:
            raise ValueError(f"virtual time cannot go backwards: {t} < {self.now}")
        self.now = float(t)
        return self.now


class EventQueue:
    """Min-heap of ``(time, seq, event)`` — deterministic FIFO tie-breaking."""

    def __init__(self):
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = 0

    def push(self, time: float, event: Any) -> None:
        if time != time:  # NaN would corrupt the heap invariant silently
            raise ValueError("event time is NaN")
        heapq.heappush(self._heap, (float(time), self._seq, event))
        self._seq += 1

    def pop(self) -> tuple[float, Any]:
        time, _, event = heapq.heappop(self._heap)
        return time, event

    def peek_time(self) -> float:
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
