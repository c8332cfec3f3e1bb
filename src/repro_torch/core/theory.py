"""Empirical validation helpers for Theorem 1 / Theorem 2 / Corollary 1.

Port of ``repro.core.theory``.  Omega comes from
:func:`repro_torch.core.rff.draw_omega` on the data's device (a
``torch.Generator`` stream, not the reference's ``jax.random`` bits).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.kernels_math import centering_matrix, gaussian_kernel, intrinsic_dim
from repro_torch.core.rff import draw_omega, rff_features
from repro_torch.core.tca import r_tca_matrix


def _features(x: torch.Tensor, n_features: int, sigma: float, seed: int) -> torch.Tensor:
    omega = draw_omega(seed, n_features, x.shape[0], sigma=sigma, device=x.device)
    return rff_features(x, omega)


def kernel_approx_error(x: torch.Tensor, n_features: int, sigma: float, seed: int) -> float:
    """Relative spectral error  ||Sigma^T Sigma - K|| / ||K||  (Theorem 2 LHS)."""
    k = gaussian_kernel(x, sigma)
    s = _features(x, n_features, sigma, seed)
    return float(torch.linalg.matrix_norm(s.T @ s - k, 2) / torch.linalg.matrix_norm(k, 2))


def corollary1_error(x: torch.Tensor, ell: torch.Tensor, gamma: float, n_features: int,
                     sigma: float, seed: int) -> float:
    """Relative spectral error between the rank-one-corrected matrices (Cor. 1)."""
    k = gaussian_kernel(x, sigma)
    s = _features(x, n_features, sigma, seed)

    def corrected(km):
        u = km @ ell
        return km - torch.outer(u, u) / (gamma + ell @ u)

    err = torch.linalg.matrix_norm(corrected(k) - corrected(s.T @ s), 2)
    return float(err / torch.linalg.matrix_norm(k, 2))


def theorem1_feature_error(x: torch.Tensor, ell: torch.Tensor, gamma: float, m: int,
                           n_features: int, sigma: float, seed: int) -> float:
    """|| H Sigma^T W_RF - H K W_R ||_F with sign-aligned eigenvectors (Thm 1 LHS).

    Both sides are the top-m eigenvectors of A_RF and A_R (eqs. 22-24); the
    sign of each eigenvector is aligned to a positive inner product.
    """
    h = centering_matrix(x.shape[1], device=x.device)
    a_r = r_tca_matrix(gaussian_kernel(x, sigma), ell, gamma)
    s = _features(x, n_features, sigma, seed)
    a_rf = r_tca_matrix(s.T @ s, ell, gamma)

    def top(a):
        return torch.linalg.eigh(a)[1].flip(1)[:, :m]

    u_r, u_rf = top(a_r), top(a_rf)
    signs = torch.sign(torch.sum(u_r * u_rf, dim=0))
    signs = torch.where(signs == 0, 1.0, signs)
    return float(torch.linalg.matrix_norm(h @ (u_rf * signs[None, :] - u_r), "fro"))


def required_features(x: torch.Tensor, sigma: float, eps: float) -> float:
    """Theorem-1 sufficient N (up to the constant):  dim(K) log(n) / eps^2."""
    k = gaussian_kernel(x, sigma)
    return float(intrinsic_dim(k) * math.log(x.shape[1]) / eps**2)
