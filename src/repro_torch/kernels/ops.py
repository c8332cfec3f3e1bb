"""Public wrappers around the port's kernels.

Port of ``repro.kernels.ops`` for this slice's kernels.  Each wrapper
launches its CUDA kernel on CUDA tensors and runs the plain version on CPU
tensors.  The CUDA kernels mask their ragged edges themselves (rows past N,
columns past n, k past p), so no operand is padded here; the reference's
``_pad_to`` has no counterpart, and the reference's ``gram_tile_plan`` (a
TPU VMEM tiling) becomes the card's chunk plan beside the kernel wrapper,
``rff_gram_stream.gram_tile_plan``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import assemble_streamed_gram_ensemble
from repro_torch.kernels import rff as _rff
from repro_torch.kernels import rff_gram_stream as _gram


def rff(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Sigma (2N, n) from X (p, n) and Omega (N, p)."""
    return _rff.rff(x, omega)


def rff_gram_stream_fused(x: torch.Tensor, ell: torch.Tensor, *, n_features: int, seed: int,
                          ensemble: int = 1, sigma_rf: float = 1.0,
                          rf_kernel: str = "gauss") -> tuple[torch.Tensor, torch.Tensor]:
    """Seed-fused (G_H (2N, 2N), u (2N,)) fp32 from X (p, n) and ell (n,).

    Neither the (2N, n) feature matrix nor the (N, p) weights exist: W_RF
    rows are drawn inside the kernel from the threefry stream, and ``ensemble``
    averages the statistics over S independently keyed draws.
    """
    gcc, gcs, gss, mc, ms = _gram.rff_gram_stream_fused(
        x, ell, n_features=n_features, seed=seed, ensemble=ensemble, sigma=sigma_rf,
        rf_kernel=rf_kernel,
    )
    return assemble_streamed_gram_ensemble(
        gcc, gcs, gss, mc, ms, n=x.shape[1], ensemble=ensemble
    )
