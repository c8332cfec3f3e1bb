"""MMD losses: exact RKHS form, RFF form, and the paper's decomposable eq. (11).

Port of ``repro.core.mmd``.  The loss between a source/target pair needs only
the two 2N-vectors msg_S = Sigma_S l_S and msg_T = Sigma_T l_T.
"""
from __future__ import annotations

import torch


def mmd_rkhs(k: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Biased squared MMD in the RKHS of kernel K:  l^T K l."""
    return ell @ (k @ ell)


def mmd_rff(sigma: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """RFF estimate:  ||Sigma l||^2."""
    msg = sigma @ ell
    return msg @ msg


def message(sigma: torch.Tensor, sign: float, n: int | None = None) -> torch.Tensor:
    """Client message  Sigma l  with l = sign * 1/n (eq. 2).  sigma: (2N, n)."""
    if n is None:
        n = sigma.shape[1]
    return sign * torch.sum(sigma, dim=1) / n


def mmd_projected(w_rf: torch.Tensor, msg_s: torch.Tensor, msg_t: torch.Tensor) -> torch.Tensor:
    """Paper eq. (11):  ||W^T (msg_S + msg_T)||^2."""
    v = w_rf.T @ (msg_s + msg_t)
    return v @ v


def mmd_projected_multi(w_rf: torch.Tensor, msgs_s: torch.Tensor, msg_t: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of per-pair losses over K source messages msgs_s (K, 2N); ``weights``
    (K,) mask the pairs, and with no weight mass the loss is 0."""
    v = (msgs_s + msg_t[None, :]) @ w_rf
    per_pair = torch.sum(v * v, dim=1)
    if weights is None:
        return torch.mean(per_pair)
    w = weights.to(per_pair.dtype)
    return torch.sum(w * per_pair) / torch.clamp_min(torch.sum(w), 1e-9)
