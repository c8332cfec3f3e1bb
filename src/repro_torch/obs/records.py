"""Typed telemetry records with a dict view (the comm ledger's snapshot).

Port of ``repro.obs.records``: :class:`Record` (a mapping facade over
dataclass fields, ``None`` fields absent, so ``"acc" in row`` is False until
an evaluation set it), the fedsim schedulers' history rows
(:class:`RoundRecord`, :class:`FlushRecord`, :class:`CrashRecord`,
:class:`EvalRecord`) and :class:`CommRecord` (``CommLog.snapshot()``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


class Record:
    """Mapping facade over dataclass fields (``None`` fields are absent)."""

    def _field_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self))

    def keys(self):
        return [n for n in self._field_names() if getattr(self, n) is not None]

    def __contains__(self, key: str) -> bool:
        return key in self._field_names() and getattr(self, key) is not None

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value) -> None:
        if key not in self._field_names():
            raise KeyError(f"{type(self).__name__} has no field {key!r}")
        setattr(self, key, value)

    def get(self, key: str, default=None):
        return getattr(self, key) if key in self else default

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def items(self):
        return [(n, getattr(self, n)) for n in self.keys()]

    def to_dict(self) -> dict:
        return dict(self.items())


@dataclass(eq=True)
class RoundRecord(Record):
    """One synchronous round at the barrier (``SyncScheduler.history``)."""

    t: float  # virtual time of the round's barrier
    round: int
    participants: int  # clients that delivered into this round's plan
    acc: float | None = None  # set when the round hit an eval_every boundary


@dataclass(eq=True)
class FlushRecord(Record):
    """One buffered aggregation (``AsyncScheduler.history``)."""

    t: float  # virtual flush time
    flush: int  # 1-based flush counter
    version: int  # server model version AFTER this flush
    members: list  # sorted client ids consumed by the flush
    staleness: list  # per-member version lag at consumption
    weights: list  # per-member staleness weights applied to the merges
    acc: float | None = None


@dataclass(eq=True)
class CrashRecord(Record):
    """A fault-plane episode: server crash/recovery or edge crash."""

    t: float
    crash: str  # "server" | "edge"
    restored_flush: int | None = None  # server: flush count rolled back to
    rollback_s: float | None = None  # server: virtual seconds replayed
    edge: int | None = None  # edge: which aggregator died
    lost: list | None = None  # edge: client ids whose updates were lost


@dataclass(eq=True)
class EvalRecord(Record):
    """A time-triggered evaluation tick (``AsyncConfig.eval_interval``)."""

    t: float
    eval: int  # tick index (1-based)
    acc: float | None = None


@dataclass(eq=True)
class CommRecord(Record):
    """Point-in-time snapshot of a :class:`repro_torch.comm.CommLog`."""

    rounds: int
    data_messages: int  # legacy float counts (Table I/II units)
    w_rf: int
    classifier: int
    bytes_by_kind: dict
    messages_by_kind: dict
    rejects_by_kind: dict
    drops_by_kind: dict
    bytes_total: int
    floats_total: int


def as_rows(history: list[Any]) -> list[dict]:
    """Render a history of records (or plain dicts) as plain dicts."""
    return [h.to_dict() if isinstance(h, Record) else dict(h) for h in history]
