"""Typed telemetry records with a dict view (the comm ledger's snapshot).

Port of the part of ``repro.obs.records`` that the comm layer uses:
:class:`Record` (a mapping facade over dataclass fields, ``None`` fields
absent) and :class:`CommRecord` (``CommLog.snapshot()``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
