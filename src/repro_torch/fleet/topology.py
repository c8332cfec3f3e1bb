"""Client-to-edge assignment for two-tier (hierarchical) federation.

Port of ``repro.fleet.topology``: numpy only, copied as it is (the port
imports nothing of the reference package).

A :class:`Topology` partitions the K source clients among E edge aggregators.
Each edge runs the *partial* merges (weighted Σℓ moment sums, weighted W_RF /
classifier sums + their weight masses) over its members and ships ONE uplink
per payload kind to the server, which completes the merge.  Because every
FedRF-TCA aggregate is a weighted sum, the edge→server split is associative:
the server-side combine of edge partials equals the flat K-client merge (see
``repro_torch.fleet.hierarchy`` for the exactness statement and its edge cases).

Topologies are plain host-side data (tuples of ints), JSON-serializable, and
validated eagerly so a bad assignment fails at construction, not inside a
compiled round.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Topology:
    """``assignment[k]`` = the edge aggregator client ``k`` reports to.

    Edge ids must form the contiguous range ``0..E-1`` with every edge
    non-empty — an empty edge would be an aggregator with no clients, which
    is always a configuration bug rather than a degenerate case.
    """

    assignment: tuple[int, ...]

    def __post_init__(self):
        if not self.assignment:
            raise ValueError("topology needs at least one client")
        asg = tuple(int(e) for e in self.assignment)
        object.__setattr__(self, "assignment", asg)
        edges = set(asg)
        if min(edges) < 0 or edges != set(range(len(edges))):
            raise ValueError(
                f"edge ids must be the contiguous range 0..E-1 with no empty "
                f"edges, got {sorted(edges)}"
            )

    @property
    def n_clients(self) -> int:
        return len(self.assignment)

    @property
    def n_edges(self) -> int:
        return max(self.assignment) + 1

    def edge_of(self, client: int) -> int:
        return self.assignment[client]

    def members(self, edge: int) -> list[int]:
        return [k for k, e in enumerate(self.assignment) if e == edge]

    @property
    def segment_ids(self) -> np.ndarray:
        """(K,) int32 edge id per client (the segment-reduce key)."""
        return np.asarray(self.assignment, dtype=np.int32)

    def edge_matrix(self) -> np.ndarray:
        """(E, K) 0/1 float32 membership matrix M: M[e, k] = 1 iff client k
        reports to edge e.  The two-tier merges are ``(M * w) @ values``."""
        m = np.zeros((self.n_edges, self.n_clients), dtype=np.float32)
        m[self.segment_ids, np.arange(self.n_clients)] = 1.0
        return m

    def edges_of(self, clients) -> list[int]:
        """Sorted distinct edges a set of clients reports to (the active
        edge uplinks of a round whose participants are ``clients``)."""
        return sorted({self.assignment[c] for c in clients})

    # -- constructors --------------------------------------------------------

    @staticmethod
    def uniform(n_clients: int, n_edges: int) -> "Topology":
        """Contiguous near-equal blocks: clients ``[k*K/E, (k+1)*K/E)`` per edge."""
        if not 1 <= n_edges <= n_clients:
            raise ValueError(f"need 1 <= n_edges={n_edges} <= n_clients={n_clients}")
        return Topology(tuple(int(k * n_edges // n_clients) for k in range(n_clients)))

    @staticmethod
    def singleton(n_clients: int) -> "Topology":
        """E = K: every client is its own edge — the degeneracy topology the
        two-tier-equals-flat tests pin down."""
        return Topology(tuple(range(n_clients)))

    @staticmethod
    def star(n_clients: int) -> "Topology":
        """E = 1: one edge aggregates the whole fleet (a flat system whose
        single uplink is the pooled merge)."""
        return Topology((0,) * n_clients)

    @staticmethod
    def of_groups(groups) -> "Topology":
        """From explicit member lists: ``of_groups([[0, 2], [1, 3]])``."""
        asg: dict[int, int] = {}
        for e, members in enumerate(groups):
            if not members:
                raise ValueError(f"group {e} is empty (an edge needs members)")
            for k in members:
                if k in asg:
                    raise ValueError(f"client {k} assigned to edges {asg[k]} and {e}")
                asg[int(k)] = e
        if sorted(asg) != list(range(len(asg))):
            raise ValueError(f"clients must be the contiguous range 0..K-1, got {sorted(asg)}")
        return Topology(tuple(asg[k] for k in range(len(asg))))
