"""Weighted segment reduce of the two-tier fleet merges (K9).

Port of ``repro.kernels.segment_reduce.segment_reduce_pallas`` and its
wrapper ``repro.kernels.ops.segment_reduce``:

    out[e, :] = sum_k M[e, k] * w[k] * values[k, :]

with M the (E, K) 0/1 membership of ``seg_ids``.  The reference contracts
the dense weighted membership ``onehot(seg) * w`` against the values, so a
non-finite value in column d of any row reaches every edge's column d
(0 * NaN = NaN); :func:`segment_reduce_plain` is that contraction, and the
kernel (``csrc/segment_reduce.cu``) sums each edge's members and writes the
same non-finite positions.

On a CUDA tensor :func:`segment_reduce` launches the kernel; on CPU tensors
it runs the plain version.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"segment_reduce": 0}
THREADS = 256  # columns per block (csrc/segment_reduce.cu kThreads)
MAX_SEGMENTS = 65535  # one grid row per segment (gridDim.y)


def segment_reduce_plain(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Plain version: ``(onehot(seg) * w) @ values`` in fp32, the reference's
    ``kernels/ref.py:76-88``."""
    seg = seg_ids.to(device=values.device)
    onehot = (seg[None, :] == torch.arange(n_segments, device=values.device)[:, None])
    wm = onehot.to(torch.float32) * weights.to(device=values.device, dtype=torch.float32)[None, :]
    return wm @ values.to(torch.float32)


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor,
                   n_segments: int) -> torch.Tensor:
    """values (K, D), seg_ids (K,) ints in [0, n_segments), weights (K,) ->
    (n_segments, D) fp32."""
    tensors = (values, seg_ids, weights)
    if all(t.device.type == "cpu" for t in tensors):
        return segment_reduce_plain(values, seg_ids, weights, n_segments)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"segment_reduce: values on {values.device}, seg_ids on "
                         f"{seg_ids.device}, weights on {weights.device}")
    if values.ndim != 2 or seg_ids.shape != (values.shape[0],) or weights.shape != seg_ids.shape:
        raise ValueError(f"segment_reduce: values {tuple(values.shape)}, seg_ids "
                         f"{tuple(seg_ids.shape)}, weights {tuple(weights.shape)}")
    if not 0 <= n_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_reduce: n_segments {n_segments} not in [0, {MAX_SEGMENTS}]")
    k, d = values.shape
    v = values.to(torch.float32).contiguous()
    seg = seg_ids.to(torch.int32).contiguous()
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((n_segments, d), dtype=torch.float32, device=v.device)
    if k == 0 or d == 0 or n_segments == 0:
        return out.zero_()
    tiles = -(-d // THREADS)
    scratch = torch.zeros((2 * d + tiles,), dtype=torch.int32, device=v.device)
    f = _build.fn("segment_reduce", "rt_segment_reduce",
                  [_build.VP, _build.VP, _build.VP, _build.I32, _build.I32, _build.I32,
                   _build.VP, _build.VP, _build.VP, _build.VP])
    with torch.cuda.device(v.device):
        err = f(v.data_ptr(), seg.data_ptr(), w.data_ptr(), k, d, n_segments, out.data_ptr(),
                scratch.data_ptr(), scratch[2 * d:].data_ptr(), _build.stream_ptr())
    _build.check(err, "segment_reduce")
    LAUNCHES["segment_reduce"] += 1
    return out
