"""Random-Fourier-feature map (K1): Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N).

Port of ``repro.kernels.rff.rff_pallas``.  On a CUDA tensor :func:`rff`
launches ``csrc/rff.cu`` (an fp32 FFMA product over p with the cos/sin
epilogue fused, written by hand); on a CPU tensor it runs :func:`rff_plain`.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = {"rff": 0}


def inv_sqrt(n: int) -> float:
    """f32(1) / sqrt(f32(n)), the scale the reference kernels fold into cos/sin."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def rff_plain(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Plain version: (p, n), (N, p) -> (2N, n), same arithmetic as the kernel."""
    z = omega @ x
    inv = inv_sqrt(omega.shape[0])
    return torch.cat([torch.cos(z) * inv, torch.sin(z) * inv], dim=0)


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.float32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 {ndim}-d tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def rff(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Sigma (2N, n) from X (p, n) and Omega (N, p)."""
    if x.device.type == "cpu" and omega.device.type == "cpu":
        return rff_plain(x, omega)
    if not (x.is_cuda and omega.is_cuda) or x.device != omega.device:
        raise ValueError(f"rff: x on {x.device}, omega on {omega.device}")
    _check(x, "x", 2)
    _check(omega, "omega", 2)
    nf, p = omega.shape
    if x.shape[0] != p:
        raise ValueError(f"rff: omega {tuple(omega.shape)} does not match x {tuple(x.shape)}")
    n = x.shape[1]
    out = torch.empty((2 * nf, n), dtype=torch.float32, device=x.device)
    if n == 0 or nf == 0:
        return out
    f = _build.fn("rff", "rt_rff", [_build.VP, _build.VP] + [_build.I32] * 3
                  + [_build.F32, _build.VP, _build.VP])
    with torch.cuda.device(x.device):
        err = f(omega.data_ptr(), x.data_ptr(), nf, p, n, inv_sqrt(nf), out.data_ptr(),
                _build.stream_ptr())
    _build.check(err, "rff")
    LAUNCHES["rff"] += 1
    return out
