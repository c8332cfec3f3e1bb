"""Synthetic LM token pipeline (a numpy-only copy of ``repro.data.lm``).

A seeded order-1 Markov token stream with Zipfian marginals: enough
structure that next-token cross-entropy decreases during training (the model
can learn the bigram table).  ``TokenStream(..., shard=(host_id, n_hosts))``
yields disjoint deterministic slices.  The same seed and shard give the
reference's arrays exactly.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(
        self,
        vocab_size: int,
        batch_size: int,
        seq_len: int,
        *,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        branching: int = 8,
    ):
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shard = shard
        rng = np.random.default_rng(seed)
        # sparse Markov table: each token has `branching` likely successors
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
        # Zipf-ish start distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._start_p = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._step = 0
        self._seed = seed

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        host, n_hosts = self.shard
        rng = np.random.default_rng((self._seed, self._step, host))
        self._step += n_hosts
        b, t = self.batch_size, self.seq_len
        toks = np.empty((b, t + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=b, p=self._start_p)
        # vectorised Markov walk with 10% uniform-noise transitions
        for i in range(t):
            nxt = self._succ[toks[:, i], rng.integers(0, self._succ.shape[1], size=b)]
            noise = rng.random(b) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab_size, size=b), nxt)
            toks[:, i + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
