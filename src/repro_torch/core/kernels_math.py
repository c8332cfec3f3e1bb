"""Exact kernel matrices, spectral utilities and the streamed-Gram assembly.

Port of ``repro.core.kernels_math``: plain functions on tensors, columns as
samples.
"""
from __future__ import annotations

import numpy as np
import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Squared Euclidean distances between columns of x (p,n) and y (p,m)."""
    if y is None:
        y = x
    xx = torch.sum(x * x, dim=0)
    yy = torch.sum(y * y, dim=0)
    d = xx[:, None] + yy[None, :] - 2.0 * (x.T @ y)
    return torch.clamp_min(d, 0.0)


def gaussian_kernel(x: torch.Tensor, sigma: float = 1.0,
                    y: torch.Tensor | None = None) -> torch.Tensor:
    """K_ij = exp(-||x_i - x_j||^2 / (2 sigma^2)), columns-as-samples."""
    return torch.exp(-pairwise_sq_dists(x, y) / (2.0 * sigma**2))


def laplace_kernel(x: torch.Tensor, sigma: float = 1.0,
                   y: torch.Tensor | None = None) -> torch.Tensor:
    """K_ij = exp(-||x_i - x_j||_2 / sigma) (the RFF-Cauchy counterpart)."""
    return torch.exp(-torch.sqrt(pairwise_sq_dists(x, y) + 1e-12) / sigma)


def intrinsic_dim(k: torch.Tensor) -> torch.Tensor:
    """dim(K) = tr(K) / ||K||_2 — controls the number of RFFs in Theorem 1/2."""
    return torch.trace(k) / torch.linalg.eigvalsh(k)[-1]


def centering_matrix(n: int, *, device=None) -> torch.Tensor:
    """H = I_n - 1 1^T / n."""
    return torch.eye(n, device=device) - torch.ones((n, n), device=device) / n


def median_sigma(x: torch.Tensor, max_n: int = 512) -> float:
    """Median-heuristic Gaussian bandwidth: sigma = sqrt(median ||xi-xj||^2 / 2)."""
    if x.shape[1] > max_n:
        x = x[:, :: x.shape[1] // max_n + 1]
    d = pairwise_sq_dists(x)
    iu = torch.triu_indices(d.shape[0], d.shape[0], offset=1, device=d.device)
    off = d[iu[0], iu[1]]
    # numpy's (and jnp's) median averages the two middle values of an even
    # count; torch.median returns the lower one
    srt = torch.sort(off).values
    k = srt.numel()
    med = srt[k // 2] if k % 2 else 0.5 * (srt[k // 2 - 1] + srt[k // 2])
    return float(torch.sqrt(med / 2.0) + 1e-12)


def _blocks(gcc, gcs, gss) -> torch.Tensor:
    return torch.cat([torch.cat([gcc, gcs], dim=1), torch.cat([gcs.T, gss], dim=1)], dim=0)


def assemble_streamed_gram(gcc, gcs, gss, u_c, u_s, s_c, s_s, *, n: int,
                           fold_n: int | None = None):
    """(G_H, u) from streamed cos/sin Gram blocks with rank-one centering.

    ``fold_n``: the true feature count N when the blocks were accumulated
    unscaled (1/sqrt(N) folded in here); None when the producer already
    normalized (the kernels fold it into cos/sin).
    """
    if fold_n is not None:
        inv2 = float(np.float32(1.0) / np.float32(fold_n))
        inv = float(np.sqrt(np.float32(inv2)))
        gcc, gcs, gss = inv2 * gcc, inv2 * gcs, inv2 * gss
        u_c, u_s, s_c, s_s = inv * u_c, inv * u_s, inv * s_c, inv * s_s
    g = _blocks(gcc, gcs, gss)
    u = torch.cat([u_c, u_s])
    col_sum = torch.cat([s_c, s_s])
    g_h = g - torch.outer(col_sum, col_sum) / n  # rank-one centering (H idempotent)
    return 0.5 * (g_h + g_h.T), u


def assemble_streamed_gram_ensemble(gcc, gcs, gss, mc, ms, *, n: int, ensemble: int):
    """(G_H, u) averaged over S draws: pooled Gram blocks, per-draw moments.

    ``mc``/``ms`` are (N, 2S), columns (2e, 2e+1) holding draw e's ell-moment
    and feature column sum, each scaled by 1/sqrt(S).  Centering is
    quadratic in the column sums, so

        G_H = G_pooled - (1/n) sum_e cs_e cs_e^T       (rank-S centering).

    ``ensemble=1`` is :func:`assemble_streamed_gram` unchanged.
    """
    if ensemble == 1:
        return assemble_streamed_gram(
            gcc, gcs, gss, mc[:, 0], ms[:, 0], mc[:, 1], ms[:, 1], n=n
        )
    g = _blocks(gcc, gcs, gss)
    inv_s = float(np.float32(1.0) / np.sqrt(np.float32(ensemble)))
    u = torch.cat([mc[:, 0::2].sum(dim=1), ms[:, 0::2].sum(dim=1)]) * inv_s
    cs = torch.cat([mc[:, 1::2], ms[:, 1::2]], dim=0)  # (2N, S)
    g_h = g - (cs @ cs.T) / n
    return 0.5 * (g_h + g_h.T), u


def ell_vector(n_s: int, n_t: int, *, device=None) -> torch.Tensor:
    """Paper eq. (2): ell_i = 1/n_S for source columns, -1/n_T for target columns."""
    return torch.cat([
        torch.full((n_s,), 1.0 / n_s, dtype=torch.float32, device=device),
        torch.full((n_t,), -1.0 / n_t, dtype=torch.float32, device=device),
    ])
