"""Dense plain-PyTorch oracles for the port's kernels.

Port of the RF-TCA, segment-reduce and attention oracles of ``repro.kernels.ref``.  They
materialize what the kernels never do (Omega, Sigma, the dense weighted
membership) and are the ground truth of the tests.
"""
from __future__ import annotations

import math

import torch

# K11's plain version is the reference's dense masked softmax itself
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as attention_ref,
)
from repro_torch.kernels.prng import fused_omega_block_plain
# K9's plain version is the reference's dense weighted-membership product itself
from repro_torch.kernels.segment_reduce import (  # noqa: F401
    segment_reduce_plain as segment_reduce_ref,
)


def rff_ref(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """(p, n), (N, p) -> (2N, n)."""
    z = (omega @ x).to(torch.float32)
    out = torch.cat([torch.cos(z), torch.sin(z)], dim=0) / math.sqrt(omega.shape[0])
    return out.to(x.dtype)


def centered_gram_ref(sigma: torch.Tensor) -> torch.Tensor:
    """(2N, n) -> (2N, 2N) fp32."""
    s = sigma.to(torch.float32)
    c = s - torch.mean(s, dim=1, keepdim=True)
    return c @ c.T


def rff_gram_stream_ref(x: torch.Tensor, omega: torch.Tensor, ell: torch.Tensor):
    """Dense oracle of the streamed Gram: (G_H (2N, 2N), u (2N,)) fp32."""
    sigma = rff_ref(x, omega).to(torch.float32)
    g_h = centered_gram_ref(sigma)
    return 0.5 * (g_h + g_h.T), sigma @ ell.to(torch.float32)


def rff_gram_stream_fused_ref(x: torch.Tensor, ell: torch.Tensor, *, n_features: int,
                              seed: int, ensemble: int = 1, sigma: float = 1.0,
                              rf_kernel: str = "gauss"):
    """Dense oracle of the seed-fused Gram: the mean over S draws of the
    per-draw centered Gram and moment, Sigma_e from the materialized draw e."""
    g_h = u = None
    for e in range(ensemble):
        omega = fused_omega_block_plain(
            seed, n_features, x.shape[0], ensemble_index=e, sigma=sigma,
            rf_kernel=rf_kernel, device=x.device,
        )
        g_e, u_e = rff_gram_stream_ref(x, omega, ell)
        g_h = g_e if g_h is None else g_h + g_e
        u = u_e if u is None else u + u_e
    return g_h / ensemble, u / ensemble

