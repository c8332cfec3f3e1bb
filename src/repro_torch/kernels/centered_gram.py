"""Centered Gram (K8): G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T = Sigma H Sigma^T.

Port of ``repro.kernels.centered_gram.centered_gram_pallas``, the statistics
of the dense RF-TCA fit (``mode="dense"``).  As in the reference, the row mean
mu is a torch reduction outside the kernel; on a CUDA tensor
:func:`centered_gram` launches ``csrc/centered_gram.cu``, which subtracts mu
from both operands as tiles are loaded, masks the ragged sample count after
that and computes the upper output tiles only, its k split from the shape
alone and summed in a fixed order (``rff_gram_stream.gram_split_plan``).
float32 Sigma takes ``csrc/gram_tf32.cuh`` (three tf32 products a product;
the upper tiles mirrored by the split's sum where k is split, here
otherwise); bfloat16 Sigma takes ``csrc/gram_bf16.cuh`` (Sigma less mu in
two bfloat16 parts, four bfloat16 products a product; the kernel or the
split's sum writes both triangles), mu being its row mean rounded to
bfloat16.  G is float32 either way, as the reference's.  On a CPU tensor it
runs :func:`centered_gram_plain`.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rff import tma_rows
from repro_torch.kernels.rff_gram_stream import gram_split_plan, mirror_upper, split_workspace

LAUNCHES = {"centered_gram": 0, "centered_gram_bf16": 0}


def row_mean(sigma: torch.Tensor) -> torch.Tensor:
    """mu (rows, 1) as the reference takes it: the fp32 mean rounded to
    Sigma's dtype (centered_gram.py:53), then widened back."""
    return sigma.mean(dim=1, keepdim=True, dtype=torch.float32).to(sigma.dtype).float()


def centered_gram_plain(sigma: torch.Tensor) -> torch.Tensor:
    """Plain version: (2N, n) -> (2N, 2N), fp32 for float32 or bfloat16 Sigma
    (both operands widened less mu, the product in fp32); wider dtypes keep
    their own."""
    if sigma.dtype.itemsize >= 4:
        c = sigma - sigma.mean(dim=1, keepdim=True)
    else:
        c = sigma.float() - row_mean(sigma)
    return c @ c.T


def split_plan(rows: int, n: int, bf16: bool) -> dict:
    """The k split the kernel takes for (rows, n) Sigma: ``gram_split_plan``
    at the library's k-tile for the dtype (builds the library)."""
    k_tile = _build.fn("centered_gram", "rt_centered_gram_k_tile", [_build.I32])(int(bf16))
    return gram_split_plan(rows, n, centered=True, k_tile=k_tile)


def centered_gram(sigma: torch.Tensor) -> torch.Tensor:
    """Sigma H Sigma^T (2N, 2N) fp32 from Sigma (2N, n), float32 or bfloat16."""
    if sigma.device.type == "cpu":
        return centered_gram_plain(sigma)
    if not sigma.is_cuda:
        raise ValueError(f"centered_gram: sigma on {sigma.device}")
    if sigma.dtype not in (torch.float32, torch.bfloat16) or sigma.ndim != 2 \
            or not sigma.is_contiguous():
        raise ValueError(f"sigma: expected contiguous float32 or bfloat16 (2N, n), got "
                         f"{sigma.dtype} {tuple(sigma.shape)}")
    rows, n = sigma.shape
    bf16 = sigma.dtype == torch.bfloat16
    if rows == 0 or n == 0:
        return torch.zeros((rows, rows), dtype=torch.float32, device=sigma.device)
    out = torch.empty((rows, rows), dtype=torch.float32, device=sigma.device)
    mu = (row_mean(sigma) if bf16 else sigma.mean(dim=1)).reshape(rows).contiguous()
    sr = tma_rows(sigma)
    plan = split_plan(rows, n, bf16)
    ws = split_workspace(plan, sigma.device)
    whole = ctypes.c_int(0)
    vp, i32 = _build.VP, _build.I32
    f = _build.fn("centered_gram", "rt_centered_gram",
                  [vp, _build.I64, i32, vp, i32, i32, vp, i32, i32, vp, vp, vp])
    with torch.cuda.device(sigma.device):
        err = f(sr.data_ptr(), sr.shape[1], int(bf16), mu.data_ptr(), rows, n, out.data_ptr(),
                plan["split"], plan["kt_per_split"], None if ws is None else ws.data_ptr(),
                ctypes.addressof(whole), _build.stream_ptr())
    _build.check(err, "centered_gram")
    LAUNCHES["centered_gram_bf16" if bf16 else "centered_gram"] += 1
    return out if whole.value else mirror_upper(out)
