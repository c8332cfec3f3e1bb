"""Unreliable-network simulation: client sampling and nested message-drop sets.

A copy of ``repro.federated.network`` (numpy only): the same plans from the
same seed.  Paper Section IV-B: at round t the participating set S_t is
drawn by first sampling |S_t| ~ Unif{0, .., K}, then that many clients
without replacement.  Table III's drop settings use nested random subsets
A ⊇ B ⊇ C: moments Sigma*ell flow for i in A, W_RF for j in B, classifiers
for k in C, in settings (I) A/A/A, (II) A/A/B and (III) A/B/C.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RoundPlan:
    msg_clients: list[int]  # A: who successfully delivers Sigma ell
    w_clients: list[int]  # B ⊆ A: whose W_RF reaches the server
    c_clients: list[int]  # C ⊆ B: whose classifier reaches the server


def sample_participants(rng: np.random.Generator, n_clients: int) -> list[int]:
    """S_t per Section IV-B: |S_t| ~ Unif{0..K}, then subset w/o replacement."""
    size = int(rng.integers(0, n_clients + 1))
    return sorted(rng.choice(n_clients, size=size, replace=False).tolist())


def _subset(rng: np.random.Generator, ids: list[int]) -> list[int]:
    if not ids:
        return []
    size = int(rng.integers(0, len(ids) + 1))
    return sorted(rng.choice(ids, size=size, replace=False).tolist())


def plan_round(rng: np.random.Generator, n_clients: int, setting: str = "I") -> RoundPlan:
    """Drop setting (I): A/A/A, (II): A/A/B, (III): A/B/C (Table III)."""
    a = sample_participants(rng, n_clients)
    if setting == "I":
        return RoundPlan(a, a, a)
    if setting == "II":
        return RoundPlan(a, a, _subset(rng, a))
    if setting == "III":
        b = _subset(rng, a)
        return RoundPlan(a, b, _subset(rng, b))
    raise ValueError(f"unknown drop setting {setting!r}")


@dataclass
class LossyChannel:
    """Bernoulli message-drop channel for the asynchronous ablations (App. D)."""

    drop_prob: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def deliver(self, payload):
        """Returns payload or None if the message is lost."""
        if self._rng.random() < self.drop_prob:
            return None
        return payload
