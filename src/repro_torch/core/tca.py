"""Vanilla TCA and R-TCA (paper Section II-B / III-B).

Port of ``repro.core.tca``: plain torch linear algebra on a precomputed n x n
kernel matrix, no kernel of its own.  Vanilla TCA's transformed features span
the top-m eigenspace of (Lemma 1)

    A = H ( K^2 - K^2 ll^T K^2 / (gamma + l^T K^2 l) ) H;

R-TCA penalises tr(W^T K W) instead, giving (eq. 22)

    A_R = (1/gamma) H ( K - K ll^T K / (gamma + l^T K l) ) H.

Both use the Sherman–Morrison rank-one form: no n x n inverse.  The aligned
representations are the top-m eigenvectors, transposed to the paper's
``W^T K in R^{m x n}`` convention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernels_math import centering_matrix


class TCAResult(NamedTuple):
    features: torch.Tensor  # (m, n) aligned features, columns are samples
    eigvals: torch.Tensor  # (m,) corresponding eigenvalues, descending


def _top_m_eigh(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m eigenpairs of a symmetric matrix, eigenvalues descending."""
    vals, vecs = torch.linalg.eigh(a)  # ascending
    return vals.flip(0)[:m], vecs.flip(1)[:, :m]


def vanilla_tca(k: torch.Tensor, ell: torch.Tensor, gamma: float, m: int) -> TCAResult:
    """Lemma-1 symmetric form of vanilla TCA on a precomputed kernel matrix."""
    h = centering_matrix(k.shape[0], device=k.device)
    k2 = k @ k
    u = k2 @ ell  # K^2 l
    a = k2 - torch.outer(u, u) / (gamma + ell @ u)
    a = h @ a @ h
    vals, vecs = _top_m_eigh(0.5 * (a + a.T), m)
    return TCAResult(features=vecs.T, eigvals=vals)


def r_tca(k: torch.Tensor, ell: torch.Tensor, gamma: float, m: int) -> TCAResult:
    """R-TCA (RKHS-norm regularisation), eq. (22)."""
    h = centering_matrix(k.shape[0], device=k.device)
    u = k @ ell
    a = k - torch.outer(u, u) / (gamma + ell @ u)
    a = (h @ a @ h) / gamma
    vals, vecs = _top_m_eigh(0.5 * (a + a.T), m)
    return TCAResult(features=vecs.T, eigvals=vals)


def r_tca_matrix(k: torch.Tensor, ell: torch.Tensor, gamma: float) -> torch.Tensor:
    """A_R itself (used by the Theorem-1 validation)."""
    h = centering_matrix(k.shape[0], device=k.device)
    u = k @ ell
    a = (k - torch.outer(u, u) / (gamma + ell @ u)) / gamma
    a = h @ a @ h
    return 0.5 * (a + a.T)
