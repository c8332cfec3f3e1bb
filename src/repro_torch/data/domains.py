"""Synthetic multi-domain datasets with controllable domain shift.

A copy of ``repro.data.domains`` (numpy only), kept here so that the port
imports nothing of the reference package; the tests hold the two equal.

Nothing is downloaded, so the paper's Office-31 / Office-Caltech / Digit-Five
benchmarks are replaced by seeded generators that expose the same experimental
axes the paper ablates:

- K source domains + 1 target domain, shared label space (UFDA, Definition 1);
- *explicit* heterogeneity: each domain is a random affine distortion (rotation,
  anisotropic scale, shift) of shared class-conditional Gaussian mixtures — large
  shift, like distinct datasets (mt vs sv);
- *implicit* heterogeneity: one domain split evenly into K+1 subsets (Fig. 5);
- class structure strong enough that source-only classifiers degrade under shift
  while distribution alignment (TCA / RF-TCA / FedRF-TCA) recovers accuracy.

Data convention matches the paper: columns are samples, ``X in R^{p x n}``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Domain:
    name: str
    x: np.ndarray  # (p, n)
    y: np.ndarray  # (n,)


def _random_rotation(rng: np.random.Generator, p: int, angle_scale: float) -> np.ndarray:
    """Random orthogonal-ish distortion: expm of a scaled skew-symmetric matrix."""
    a = rng.normal(size=(p, p))
    skew = (a - a.T) / 2
    # Pade-free expm via eigendecomposition of the skew-Hermitian matrix
    w, v = np.linalg.eigh(1j * skew * angle_scale)
    return np.real(v @ np.diag(np.exp(-1j * w)) @ v.conj().T)


def make_domains(
    n_domains: int,
    n_per_domain: int,
    *,
    n_classes: int = 5,
    dim: int = 16,
    shift: float = 0.8,
    class_sep: float = 3.0,
    noise: float = 0.6,
    seed: int = 0,
) -> list[Domain]:
    """Explicit heterogeneity: one latent mixture, per-domain affine distortions.

    ``shift`` controls the distortion magnitude (0 = iid domains).
    """
    rng = np.random.default_rng(seed)
    # shared class prototypes on a scaled simplex-ish arrangement
    protos = rng.normal(size=(n_classes, dim))
    protos *= class_sep / np.linalg.norm(protos, axis=1, keepdims=True)
    domains = []
    for d in range(n_domains):
        # partial shift, like real DA benchmarks: mild rotation (class identity
        # stays recoverable) + translation + anisotropic scale. A full random
        # rotation would make UFDA unidentifiable from marginals alone.
        rot = _random_rotation(rng, dim, angle_scale=0.35 * shift)
        scale = 1.0 + shift * rng.uniform(-0.4, 0.4, size=(dim,))
        offset = 1.2 * shift * rng.normal(size=(dim,))
        y = rng.integers(0, n_classes, size=n_per_domain)
        x = protos[y] + noise * rng.normal(size=(n_per_domain, dim))
        x = (x * scale) @ rot.T + offset
        domains.append(Domain(name=f"dom{d}", x=x.T.astype(np.float32), y=y.astype(np.int32)))
    return domains


def make_implicit_domains(
    n_domains: int, n_per_domain: int, *, seed: int = 0, **kw
) -> list[Domain]:
    """Implicit heterogeneity (Fig. 5): one domain split into similar subsets."""
    base = make_domains(1, n_per_domain * n_domains, seed=seed, **kw)[0]
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(base.x.shape[1])
    out = []
    for d in range(n_domains):
        idx = perm[d * n_per_domain : (d + 1) * n_per_domain]
        out.append(Domain(name=f"split{d}", x=base.x[:, idx], y=base.y[idx]))
    return out


def train_test_split(dom: Domain, test_frac: float = 0.3, seed: int = 0) -> tuple[Domain, Domain]:
    rng = np.random.default_rng(seed)
    n = dom.x.shape[1]
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return (
        Domain(dom.name + "_tr", dom.x[:, tr], dom.y[tr]),
        Domain(dom.name + "_te", dom.x[:, te], dom.y[te]),
    )


def normalize_unit(x: np.ndarray) -> np.ndarray:
    """Unit-Euclidean-norm columns, as the paper preprocesses DeCAF6 features."""
    return x / (np.linalg.norm(x, axis=0, keepdims=True) + 1e-12)


class BatchStream:
    """Infinite shuffled minibatch stream over columns of x.

    Same draw sequence as the generator it replaced (one permutation per
    epoch, consecutive ``batch_size`` slices while a full batch fits), but
    with *capturable* state: :meth:`state` returns a JSON-serializable dict
    and :meth:`set_state` rewinds the stream exactly — the checkpoint
    machinery's requirement for bitwise save -> restore -> continue.  State
    is compact: the rng state captured *before* each permutation draw plus
    the position in it, so restore re-draws the identical permutation
    instead of serializing index arrays.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
        self.x, self.y = x, y
        self.batch_size = int(batch_size)
        self.n = x.shape[1]
        if not 0 < self.batch_size <= self.n:
            # the old generator would silently spin forever on batch > n
            raise ValueError(f"batch_size {batch_size} not in [1, {self.n}]")
        self.rng = np.random.default_rng(seed)
        self._new_epoch()

    def _new_epoch(self) -> None:
        self._perm_state = self.rng.bit_generator.state
        self._perm = self.rng.permutation(self.n)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i + self.batch_size > self.n:
            self._new_epoch()
        idx = self._perm[self._i : self._i + self.batch_size]
        self._i += self.batch_size
        return self.x[:, idx], self.y[idx]

    def state(self) -> dict:
        return {"perm_state": self._perm_state, "i": self._i}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["perm_state"]
        self._new_epoch()
        self._i = int(state["i"])


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Infinite shuffled minibatch stream over columns of x (a
    :class:`BatchStream`; kept as the seed-era constructor name)."""
    return BatchStream(x, y, batch_size, seed=seed)
