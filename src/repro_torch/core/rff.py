"""Random Fourier features (paper Definition 2).

Port of ``repro.core.rff``.  For data X in R^{p x n} (columns are samples)

    Sigma = (1/sqrt(N)) [cos(Omega X); sin(Omega X)]  in  R^{2N x n}.

:func:`rff_features` launches the K1 kernel on a CUDA tensor and runs its
plain version on a CPU tensor (``kernels.rff``).
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def draw_omega(seed: int, n_features: int, dim: int, sigma: float = 1.0,
               kernel: Literal["gauss", "laplace"] = "gauss", *, device=None) -> torch.Tensor:
    """Shared-seed frequency matrix Omega in R^{N x p} from a ``torch.Generator``.

    gauss: N(0, 1/sigma^2); laplace: Cauchy(0, 1/sigma).  The stream is
    PyTorch's, so it is NOT bit-equal to ``repro.core.rff.draw_omega``
    (``jax.random``); the portable seed-defined draw is
    ``kernels.prng.fused_omega``.  It is drawn on a CPU generator and then
    moved to ``device``, so one seed gives one Omega on every device (as the
    reference's draw does on every backend): a state fitted on one device
    and used on another pairs its W_RF with the same Omega.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if kernel == "gauss":
        om = torch.randn((n_features, dim), generator=gen)
    elif kernel == "laplace":
        om = torch.empty((n_features, dim)).cauchy_(generator=gen)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return (om / sigma).to(dev)


def rff_features(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N), (2N, n) from x (p, n)."""
    return ops.rff(x.contiguous(), omega.contiguous())


def rff_features_rows(x_rows: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Row-major convenience: x_rows (n, p) -> (n, 2N)."""
    return rff_features(x_rows.T.contiguous(), omega).T


def rff_message(x: torch.Tensor, omega: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """The paper's compressed client message  Sigma ell  in R^{2N} (eq. 2)."""
    return sign * torch.sum(rff_features(x, omega), dim=1) / x.shape[1]
