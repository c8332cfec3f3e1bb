"""Random-Fourier-feature map: Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N).

Port of ``repro.kernels.rff``: ``rff_pallas`` (K1, Omega an operand) and
``rff_fused_pallas`` (K7, Omega drawn inside the kernel from the threefry
stream of ``kernels.prng``).  On CUDA tensors :func:`rff` and
:func:`rff_fused` launch ``csrc/rff.cu``, the cos/sin epilogue fused into
the product over p, written by hand: K1 an fp32 FFMA product
(``csrc/featurize.cuh``), K7 three tf32 products on the tensor cores with
Omega drawn beside them (``csrc/featurize_tf32.cuh``).  On CPU tensors they
run :func:`rff_plain` and :func:`rff_fused_plain`.  ``LAUNCHES`` counts the
kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prng import _KINDS, _MASK, _inv_sigma, fused_omega_block_plain

LAUNCHES = {"rff": 0, "rff_fused": 0}


def tma_rows(x: torch.Tensor) -> torch.Tensor:
    """A row-major matrix (X, an Omega operand, Sigma) as the tensor-core
    kernels' TMA loads take it: rows a multiple of 4 floats apart and 16-byte
    aligned; otherwise a copy with zero columns appended."""
    n = x.shape[1]
    if n % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((x.shape[0], -(-n // 4) * 4), dtype=x.dtype, device=x.device)
    out[:, :n] = x
    return out


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


def rff_fused_plain(x: torch.Tensor, *, n_features: int, seed: int, ensemble_index: int = 0,
                    sigma: float = 1.0, rf_kernel: str = "gauss") -> torch.Tensor:
    """Plain version of :func:`rff_fused`: Omega materialized by the plain
    threefry draw, then :func:`rff_plain`."""
    om = fused_omega_block_plain(seed, n_features, x.shape[0], ensemble_index=ensemble_index,
                                 sigma=sigma, rf_kernel=rf_kernel, device=x.device)
    return rff_plain(x, om)


def counter_ptr(counters: torch.Tensor | None) -> int | None:
    """The device pointer of a tensor-core featurize's counters, or None.

    ``counters`` is a CUDA int64 tensor of 3, to which the kernel adds the
    Omega elements its producers drew, the phases of |z| >= 64 it recomputed
    as fp32's FMA chain and the Omega elements that recompute drew (with an
    Omega operand, the phases only)."""
    if counters is None:
        return None
    if counters.dtype != torch.int64 or tuple(counters.shape) != (3,) or not counters.is_cuda:
        raise ValueError(f"counters: expected a CUDA int64 tensor of 3, got {counters.dtype} "
                         f"{tuple(counters.shape)} on {counters.device}")
    return counters.data_ptr()


def rff_fused(x: torch.Tensor, *, n_features: int, seed: int, ensemble_index: int = 0,
              sigma: float = 1.0, rf_kernel: str = "gauss",
              counters: torch.Tensor | None = None) -> torch.Tensor:
    """Seed-fused Sigma (2N, n) from X (p, n): no Omega operand; draw
    ``ensemble_index`` of the stream keyed by ``seed`` is drawn in the kernel.
    ``counters``: see :func:`counter_ptr` (CUDA tensors only)."""
    if rf_kernel not in _KINDS:
        raise ValueError(f"unknown rf kernel {rf_kernel!r}")
    if x.device.type == "cpu":
        return rff_fused_plain(x, n_features=n_features, seed=seed,
                               ensemble_index=ensemble_index, sigma=sigma, rf_kernel=rf_kernel)
    if not x.is_cuda:
        raise ValueError(f"rff_fused: x on {x.device}")
    _check(x, "x", 2)
    p, n = x.shape
    out = torch.empty((2 * n_features, n), dtype=torch.float32, device=x.device)
    if n == 0 or n_features == 0:
        return out
    f = _build.fn("rff", "rt_rff_fused", [_build.U32, _build.U32, _build.F32, _build.I32,
                                          _build.VP, _build.I64] + [_build.I32] * 3
                  + [_build.F32, _build.VP, _build.VP, _build.VP])
    xr = tma_rows(x)
    with torch.cuda.device(x.device):
        err = f(seed & _MASK, ensemble_index & _MASK, _inv_sigma(sigma), _KINDS[rf_kernel],
                xr.data_ptr(), xr.shape[1], n_features, p, n, inv_sqrt(n_features),
                out.data_ptr(), counter_ptr(counters), _build.stream_ptr())
    _build.check(err, "rff_fused")
    LAUNCHES["rff_fused"] += 1
    return out
