"""Centered Gram (K8): G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T = Sigma H Sigma^T.

Port of ``repro.kernels.centered_gram.centered_gram_pallas``, the statistics
of the dense RF-TCA fit (``mode="dense"``).  As in the reference, the row mean
mu is a torch reduction outside the kernel; on a CUDA tensor
:func:`centered_gram` launches ``csrc/centered_gram.cu`` (the tensor-core
Gram of ``csrc/gram_tf32.cuh``: three tf32 products a product), which
subtracts mu from both operands as tiles are loaded, masks the ragged sample
count after that and computes the upper output tiles only; on a CPU tensor
it runs :func:`centered_gram_plain`.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rff import tma_rows
from repro_torch.kernels.rff_gram_stream import mirror_upper

LAUNCHES = {"centered_gram": 0}


def centered_gram_plain(sigma: torch.Tensor) -> torch.Tensor:
    """Plain version: (2N, n) -> (2N, 2N) fp32."""
    c = sigma - sigma.mean(dim=1, keepdim=True)
    return c @ c.T


def centered_gram(sigma: torch.Tensor) -> torch.Tensor:
    """Sigma H Sigma^T (2N, 2N) fp32 from Sigma (2N, n)."""
    if sigma.device.type == "cpu":
        return centered_gram_plain(sigma)
    if not sigma.is_cuda:
        raise ValueError(f"centered_gram: sigma on {sigma.device}")
    if sigma.dtype != torch.float32 or sigma.ndim != 2 or not sigma.is_contiguous():
        raise ValueError(f"sigma: expected contiguous float32 (2N, n), got {sigma.dtype} "
                         f"{tuple(sigma.shape)}")
    rows, n = sigma.shape
    out = torch.zeros((rows, rows), dtype=torch.float32, device=sigma.device)
    if rows == 0 or n == 0:
        return out
    mu = sigma.mean(dim=1).contiguous()
    sr = tma_rows(sigma)
    f = _build.fn("centered_gram", "rt_centered_gram",
                  [_build.VP, _build.I64, _build.VP, _build.I32, _build.I32, _build.VP, _build.VP])
    with torch.cuda.device(sigma.device):
        err = f(sr.data_ptr(), sr.shape[1], mu.data_ptr(), rows, n, out.data_ptr(),
                _build.stream_ptr())
    _build.check(err, "centered_gram")
    LAUNCHES["centered_gram"] += 1
    return mirror_upper(out)
