"""Fused stochastic-rounding quantize -> dequantize (K10).

Port of ``repro.kernels.quantize.fake_quant_pallas``, the qint8/qint4 wire
codecs' round trip (``comm.codecs.QuantCodec.roundtrip``) inside the batched
round engine.  Each row of an (R, D) stack is one payload with its own
absmax scale: the reference's ``jax.vmap(codec.roundtrip)`` over the client
axis computes one scale per client, and the port gets the same result with
ONE kernel launch on the whole stack, outside ``torch.func.vmap`` (a ctypes
kernel has no batching rule).

Two entry points into ``csrc/quantize.cu``: :func:`fake_quant_rows`, the
codec round trip, computes each row's scale inside the kernel (one launch,
x read once; ``u=None`` is the constant 0.5 there), and :func:`fake_quant`
takes the scales given.  On CPU tensors each runs its plain version
(:func:`quant_scale` and :func:`fake_quant_plain`, the same formula in torch
ops).  ``LAUNCHES`` counts the launches of either kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"fake_quant": 0}
MAX_ROWS = 65535  # one grid row per payload (gridDim.y)


def qmax_of(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"fake_quant: bits must be 4 or 8, got {bits}")
    return (1 << (bits - 1)) - 1


def quant_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Per-row scale (R,) of an (R, D) stack: absmax / qmax, or 1 for an
    all-zero row or one holding a NaN (the reference's
    ``kernels/ops.py:316-318``).  The divide is a true one on every device:
    a tensor divisor, since CUDA torch multiplies by the reciprocal of a
    Python-number divisor."""
    absmax = x.abs().amax(dim=1)
    return torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                       torch.ones_like(absmax))


def fake_quant_plain(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, *,
                     qmax: int) -> torch.Tensor:
    """Plain version: ``clip(floor(x / scale[r] + u), -qmax, qmax) * scale[r]``."""
    s = scale[:, None]
    return torch.clamp(torch.floor(x / s + u), -qmax, qmax) * s


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"fake_quant: {name} must be contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def fake_quant(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, *,
               qmax: int) -> torch.Tensor:
    """x (R, D), u (R, D) uniforms in [0, 1), scale (R,) -> (R, D) fp32."""
    if x.device.type == "cpu" and u.device.type == "cpu" and scale.device.type == "cpu":
        return fake_quant_plain(x, u, scale, qmax=qmax)
    if not (x.is_cuda and u.is_cuda and scale.is_cuda) or len({x.device, u.device,
                                                               scale.device}) != 1:
        raise ValueError(f"fake_quant: x on {x.device}, u on {u.device}, scale on {scale.device}")
    if x.ndim != 2:
        raise ValueError(f"fake_quant: x must be (R, D), got {tuple(x.shape)}")
    rows, d = x.shape
    _check(x, "x", (rows, d))
    _check(u, "u", (rows, d))
    _check(scale, "scale", (rows,))
    if rows > MAX_ROWS:
        raise ValueError(f"fake_quant: {rows} rows > {MAX_ROWS}")
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    f = _build.fn("quantize", "rt_fake_quant", [_build.VP, _build.VP, _build.VP, _build.I32,
                                                _build.I32, _build.F32, _build.VP, _build.VP])
    with torch.cuda.device(x.device):
        err = f(x.data_ptr(), u.data_ptr(), scale.data_ptr(), rows, d, float(qmax),
                out.data_ptr(), _build.stream_ptr())
    _build.check(err, "fake_quant")
    LAUNCHES["fake_quant"] += 1
    return out


def _check_rows(x: torch.Tensor, u: torch.Tensor | None) -> None:
    if u is not None and (not u.is_cuda or u.device != x.device):
        raise ValueError(f"fake_quant_rows: x on {x.device}, u on {u.device}")
    if x.ndim != 2:
        raise ValueError(f"fake_quant_rows: x must be (R, D), got {tuple(x.shape)}")
    _check(x, "x", tuple(x.shape))
    if u is not None:
        _check(u, "u", tuple(x.shape))
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"fake_quant_rows: {x.shape[0]} rows > {MAX_ROWS}")


def fake_quant_fused(x: torch.Tensor, u: torch.Tensor | None, *, qmax: int) -> torch.Tensor:
    """x (R, D) fp32, u (R, D) uniforms in [0, 1) or None (0.5) -> (R, D)
    fp32, each row through its own absmax scale: on a CUDA tensor one launch
    that computes the scales itself; on a CPU tensor :func:`quant_scale` and
    :func:`fake_quant_plain`."""
    if x.device.type == "cpu" and (u is None or u.device.type == "cpu"):
        uf = torch.full_like(x, 0.5) if u is None else u
        return fake_quant_plain(x, uf, quant_scale(x, qmax), qmax=qmax)
    if not x.is_cuda:
        raise ValueError(f"fake_quant_rows: x on {x.device}")
    _check_rows(x, u)
    out = torch.empty_like(x)
    rows, d = x.shape
    if rows == 0 or d == 0:
        return out
    f = _build.fn("quantize", "rt_fake_quant_rows", [_build.VP, _build.VP, _build.I32,
                                                     _build.I32, _build.F32, _build.VP,
                                                     _build.VP])
    with torch.cuda.device(x.device):
        err = f(x.data_ptr(), u.data_ptr() if u is not None else None, rows, d, float(qmax),
                out.data_ptr(), _build.stream_ptr())
    _build.check(err, "fake_quant_rows")
    LAUNCHES["fake_quant"] += 1
    return out


def fake_quant_rows(x: torch.Tensor, u: torch.Tensor | None, *, bits: int) -> torch.Tensor:
    """The codec round trip of a stack of payloads: x (R, ...) with one
    absmax scale per row; ``u`` the uniforms (same shape), or ``None`` for
    round-half-up (u = 0.5), as the reference does without a key.  A
    contiguous float32 stack goes to :func:`fake_quant_fused` as it is."""
    qmax = qmax_of(bits)
    rows = x.shape[0]
    xf = x.to(torch.float32).reshape(rows, -1).contiguous()
    uf = None if u is None else u.to(torch.float32).reshape(rows, -1).contiguous()
    out = fake_quant_fused(xf, uf, qmax=qmax)
    return out.reshape(x.shape).to(x.dtype)
