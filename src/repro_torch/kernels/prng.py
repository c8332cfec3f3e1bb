"""Counter-based threefry-2x32 draws of the seed-fused Omega (K4).

Port of ``repro.kernels.prng``.  Element ``(row, col)`` of draw ``e`` under
seed ``s`` is a pure function of its absolute coordinates:

    key     = (s & 0xFFFFFFFF, e)
    counter = (row, col)
    bits    = threefry2x32(key, counter)          2 x uint32
    omega   = box_muller(bits) * f32(1/sigma)     gauss
            = tan-cauchy(bits) * f32(1/sigma)     laplace

The plain version below computes the uint32 arithmetic in int64 masked to 32
bits, because PyTorch on the CPU has no uint32 add or shift.  Its bits equal
the reference's exactly; its floats go through PyTorch's ``log1p``, ``cos``
and ``tan``, which agree with XLA's to a few ULP (the tests state the bound).

On a CUDA device :func:`fused_omega_block` and :func:`threefry_bits` launch
``csrc/prng.cu`` (the ``__device__`` generator of ``csrc/threefry.cuh``,
which the fused Gram kernel also calls); on the CPU they run the plain
version.  ``device=None`` is the card, as at every entry point of the port,
and raises where there is none.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
_TWO_PI = float(np.float32(6.283185307179586))  # the f32 value, held exactly
_PI = float(np.float32(np.pi))
_KINDS = {"gauss": 0, "laplace": 1}

LAUNCHES = {"threefry_bits": 0, "fused_omega": 0}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """20-round threefry-2x32 of counter ``(c0, c1)`` under key ``(k0, k1)``.

    Keys are Python ints in [0, 2^32); counters are int64 tensors holding
    uint32 values.  Returns two int64 tensors of uint32 values.
    """
    ks = (k0 & _MASK, k1 & _MASK, (_PARITY ^ k0 ^ k1) & _MASK)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _MASK
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _MASK
    return x0, x1


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> fp32 uniform on [0, 1) with 24-bit resolution."""
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def _normal(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Box-Muller: sqrt(-2 log1p(-u1)) * cos(f32(2 pi) * u2)."""
    u1 = _uniform(b0)
    u2 = _uniform(b1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos(_TWO_PI * u2)


def _cauchy(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """tan-Cauchy on the first word: tan(f32(pi) * (u - 0.5))."""
    return torch.tan(_PI * (_uniform(b0) - 0.5))


_DISTS = {"gauss": _normal, "laplace": _cauchy}


def _counters(rows: int, cols: int, row0: int, col0: int, device) -> tuple:
    r = (row0 + torch.arange(rows, dtype=torch.int64, device=device)) & _MASK
    c = (col0 + torch.arange(cols, dtype=torch.int64, device=device)) & _MASK
    return r[:, None].expand(rows, cols), c[None, :].expand(rows, cols)


def _inv_sigma(sigma: float) -> float:
    return float(np.float32(1.0 / sigma))


def threefry_bits_plain(seed, rows, cols, *, row0=0, col0=0, ensemble_index=0,
                        device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw bit pair of each element of a ``(rows, cols)`` counter block,
    as int64 tensors of uint32 values.  ``device=None`` is the card."""
    r, c = _counters(rows, cols, row0, col0, resolve_device(device))
    return threefry2x32(seed & _MASK, ensemble_index, r, c)


def fused_omega_block_plain(seed, rows, cols, *, row0=0, col0=0, ensemble_index=0,
                            sigma=1.0, rf_kernel="gauss", device=None) -> torch.Tensor:
    """Plain version of :func:`fused_omega_block` (int64 threefry) on
    ``device`` (``None`` is the card)."""
    if rf_kernel not in _DISTS:
        raise ValueError(f"unknown rf kernel {rf_kernel!r}")
    b0, b1 = threefry_bits_plain(
        seed, rows, cols, row0=row0, col0=col0, ensemble_index=ensemble_index,
        device=device,
    )
    draw = _DISTS[rf_kernel](b0, b1)
    if sigma != 1.0:
        draw = draw * _inv_sigma(sigma)
    return draw


def _check_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {dev}")
    return dev


def threefry_bits(seed, rows, cols, *, row0=0, col0=0, ensemble_index=0, device=None):
    """Bit pair of a counter block: the CUDA kernel on a CUDA device
    (``device=None`` is the card), the plain version on the CPU.  Both return
    int64 tensors of uint32 values (the kernel writes the bit patterns into
    int32 buffers)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return threefry_bits_plain(
            seed, rows, cols, row0=row0, col0=col0, ensemble_index=ensemble_index,
            device=dev,
        )
    _check_cuda(dev)
    out0 = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    out1 = torch.empty_like(out0)
    f = _build.fn("prng", "rt_threefry_bits", [_build.U32] * 4 + [_build.I32] * 2
                  + [_build.VP] * 3)
    with torch.cuda.device(dev):
        err = f(seed & _MASK, ensemble_index & _MASK, row0 & _MASK, col0 & _MASK,
                rows, cols, out0.data_ptr(), out1.data_ptr(), _build.stream_ptr())
    _build.check(err, "threefry_bits")
    LAUNCHES["threefry_bits"] += 1
    return out0.to(torch.int64) & _MASK, out1.to(torch.int64) & _MASK


def fused_omega_block(seed, rows, cols, *, row0=0, col0=0, ensemble_index=0,
                      sigma=1.0, rf_kernel="gauss", device=None) -> torch.Tensor:
    """A ``(rows, cols)`` block of the seed-defined Omega at ``(row0, col0)``.

    gauss: N(0, 1/sigma^2); laplace: Cauchy(0, 1/sigma).  Launches the CUDA
    kernel on a CUDA device (``device=None`` is the card), runs the plain
    version on the CPU.
    """
    if rf_kernel not in _DISTS:
        raise ValueError(f"unknown rf kernel {rf_kernel!r}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fused_omega_block_plain(
            seed, rows, cols, row0=row0, col0=col0, ensemble_index=ensemble_index,
            sigma=sigma, rf_kernel=rf_kernel, device=dev,
        )
    _check_cuda(dev)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    f = _build.fn("prng", "rt_fused_omega", [_build.U32, _build.U32, _build.F32, _build.I32]
                  + [_build.U32] * 2 + [_build.I32] * 2 + [_build.VP] * 2)
    with torch.cuda.device(dev):
        err = f(seed & _MASK, ensemble_index & _MASK, _inv_sigma(sigma), _KINDS[rf_kernel],
                row0 & _MASK, col0 & _MASK, rows, cols, out.data_ptr(),
                _build.stream_ptr())
    _build.check(err, "fused_omega")
    LAUNCHES["fused_omega"] += 1
    return out


def fused_omega(seed, n_features, dim, *, ensemble_index=0, sigma=1.0,
                rf_kernel="gauss", device=None) -> torch.Tensor:
    """The full ``(N, p)`` Omega of the fused stream (the transform memo's
    draw); equal to assembling :func:`fused_omega_block` tiles at any tiling."""
    return fused_omega_block(
        seed, n_features, dim, ensemble_index=ensemble_index, sigma=sigma,
        rf_kernel=rf_kernel, device=device,
    )
