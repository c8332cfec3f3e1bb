"""Model store for the serving plane: fitted aligner/classifier states.

A copy of ``repro.serve.store`` (host-side Python; the states it holds keep
their tensors on their device).

Entries are keyed by ``(domain_pair, codec, version)`` — the domain pair a
state was fitted on, the wire codec its downlinks use, and a monotone version
tag.  Two policies govern the cache:

- **LRU capacity.**  The store holds at most ``capacity`` entries; a ``put``
  past capacity evicts the least-recently-used entry (a ``get`` hit counts as
  use).  Serving a long tail of domain pairs therefore works with bounded
  memory, and the hit rate is the bench's cache headline.
- **Version-tagged invalidation.**  ``put`` with ``bump=True`` (the refresh
  path — e.g. enough admitted moments accumulated to warrant a re-solve)
  stores the state under ``latest_version + 1`` and drops every older version
  of the same ``(domain_pair, codec)``; a reader that pinned an old version
  gets a miss, never a stale aligner.  Plain admission does NOT bump — the
  refit-free contract is that admitting a client changes no cached version.

All counters (hits / misses / evictions / invalidations) are host-side ints
mirrored into the ``obs`` metrics registry (no-op by default, so serving with
telemetry off is bitwise identical).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

from repro_torch.obs import metrics

StoreKey = tuple  # (domain_pair, codec, version)


@dataclass
class MomentStats:
    """Incrementally-merged Sigma-ell moment statistics of one domain pair.

    The paper's only data-dependent message is the per-client moment (eq. 2):
    source mean with sign +1, target mean with sign -1, and the fit's
    ``u = Sigma ell`` is ``source_mean - target_mean`` — an associative
    weighted mean, so a new client's moments merge in O(2N) with no refit
    (the same associativity the fleet hierarchy exploits).
    """

    source_mean: Any = None  # (2N,) running mean of source RFF rows
    n_source: int = 0
    target_mean: Any = None  # (2N,) running mean of target RFF rows
    n_target: int = 0
    admitted: int = 0  # clients merged since the state was solved

    def merge(self, moment, n_samples: int, *, role: str = "source") -> None:
        """Fold one admitted client's mean moment vector into the stats.

        ``moment`` is the client's signed Sigma-ell message (sign +1 source,
        -1 target, matching ``federated.model.client_message``); the running
        means store the unsigned row means.
        """
        if role not in ("source", "target"):
            raise ValueError(f"role must be 'source' or 'target', got {role!r}")
        if n_samples <= 0:
            raise ValueError(f"n_samples must be > 0, got {n_samples}")
        sign = 1.0 if role == "source" else -1.0
        mean = sign * moment  # undo the wire sign -> plain row mean
        if role == "source":
            tot = self.n_source + n_samples
            self.source_mean = (
                mean if self.source_mean is None
                else (self.n_source * self.source_mean + n_samples * mean) / tot
            )
            self.n_source = tot
        else:
            tot = self.n_target + n_samples
            self.target_mean = (
                mean if self.target_mean is None
                else (self.n_target * self.target_mean + n_samples * mean) / tot
            )
            self.n_target = tot
        self.admitted += 1

    @property
    def u(self):
        """The fit statistic ``u = source_mean - target_mean`` (None until
        both sides have contributed)."""
        if self.source_mean is None or self.target_mean is None:
            return None
        return self.source_mean - self.target_mean


@dataclass
class StoreEntry:
    """One cached model: the fitted aligner state + serving sidecar."""

    state: Any  # core.rf_tca.RFTCAState (tensors on the serving device)
    classifier: Any = None  # optional {"w", "b"} head for predict requests
    stats: MomentStats = field(default_factory=MomentStats)
    fit_kw: dict = field(default_factory=dict)  # enough to refit on refresh
    gram: Any = None  # fit-time merged G_H (on the state's device): moment-space re-solve


class ModelStore:
    """LRU-of-fitted-states keyed by ``(domain_pair, codec, version)``."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[StoreKey, StoreEntry] = OrderedDict()
        self._latest: dict[tuple, int] = {}  # (domain_pair, codec) -> version
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def _pair_key(domain_pair, codec: str) -> tuple:
        return (tuple(domain_pair), str(codec))

    def latest_version(self, domain_pair, codec: str = "float32") -> int | None:
        """Newest stored version of the pair, or None when absent/evicted."""
        v = self._latest.get(self._pair_key(domain_pair, codec))
        if v is not None and (tuple(domain_pair), str(codec), v) not in self._entries:
            return None  # the LRU evicted the newest version out from under us
        return v

    def get(
        self, domain_pair, codec: str = "float32", version: int | None = None
    ) -> StoreEntry | None:
        """Fetch (and LRU-touch) an entry; ``version=None`` means newest."""
        if version is None:
            version = self._latest.get(self._pair_key(domain_pair, codec))
        key = (tuple(domain_pair), str(codec), version)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            metrics().counter("serve.store.misses").inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        metrics().counter("serve.store.hits").inc()
        return entry

    def put(
        self,
        domain_pair,
        entry: StoreEntry,
        *,
        codec: str = "float32",
        bump: bool = False,
    ) -> int:
        """Insert ``entry``; returns the version it was stored under.

        ``bump=False`` (default) writes version 0 on first insert and
        *overwrites* the current latest version otherwise — the refit-free
        admission path updates an entry's stats in place and never lands
        here.  ``bump=True`` is the invalidation path: the entry is stored
        under ``latest + 1`` and every older version of the pair is dropped.
        """
        pk = self._pair_key(domain_pair, codec)
        current = self._latest.get(pk)
        if current is None:
            version = 0
        elif bump:
            version = current + 1
            dropped = [k for k in self._entries if k[:2] == pk and k[2] < version]
            for k in dropped:
                del self._entries[k]
            self.invalidations += len(dropped)
            metrics().counter("serve.store.invalidations").inc(len(dropped))
        else:
            version = current
        key = (*pk, version)
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._latest[pk] = version
        while len(self._entries) > self.capacity:
            old_key, _ = self._entries.popitem(last=False)
            self.evictions += 1
            metrics().counter("serve.store.evictions").inc()
            if self._latest.get(old_key[:2]) == old_key[2]:
                del self._latest[old_key[:2]]
        return version

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: StoreKey) -> bool:
        return tuple(key) in self._entries

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        """JSON-ready counters for the bench record."""
        return {
            "capacity": self.capacity,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "hit_rate": self.hit_rate,
        }
