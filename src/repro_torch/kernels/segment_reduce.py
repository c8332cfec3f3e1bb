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

With ``with_mass=True`` the call also returns the edge masses ``mass[e] =
sum_k M[e, k] * w[k]``: the kernel writes them itself, and the plain version
contracts ``[values | 1]`` and splits it, as the reference's
``fleet.hierarchy._sums_and_mass`` does.  The kernel reads the membership
from a :class:`MembershipPlan`, built once per topology on the host by
:func:`membership_plan` and passed in place of the segment ids; given the ids
alone, the wrapper builds the plan on the device.

On CUDA tensors :func:`segment_reduce` launches the kernel; on CPU tensors
it runs the plain version.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = {"segment_reduce": 0}
MAX_SEGMENTS = 65535  # gridDim.y of the kernel's grid
_WORKSPACE: dict = {}  # (device, stream) -> the kernel's int32 flags, zeroed once


class MembershipPlan(NamedTuple):
    """The segment ids and their rows grouped by segment: segment e's rows, in
    ascending k, are ``order[offsets[e]:offsets[e + 1]]``; rows with ids below
    0 come before ``offsets[0]``, those at or past E after ``offsets[E]``.
    The plain version reads ``seg_ids``, the kernel ``order`` and ``offsets``."""

    seg_ids: torch.Tensor  # (K,) the ids the plan was built from
    order: torch.Tensor  # (K,) int32
    offsets: torch.Tensor  # (E + 1,) int32


def membership_plan(seg_ids, n_segments: int, device=None) -> MembershipPlan:
    """The plan of host segment ids (numpy or a CPU tensor): a stable
    argsort and the segments' first positions, built with numpy and copied to
    ``device`` once."""
    ids = np.asarray(seg_ids).reshape(-1)
    seg = ids.astype(np.int64)
    order = np.argsort(seg, kind="stable")
    offsets = np.searchsorted(seg[order], np.arange(n_segments + 1), side="left")
    return MembershipPlan(torch.as_tensor(ids, device=device),
                          torch.as_tensor(order.astype(np.int32), device=device),
                          torch.as_tensor(offsets.astype(np.int32), device=device))


def _device_plan(seg_ids: torch.Tensor, n_segments: int) -> MembershipPlan:
    """The plan built on the ids' device: a stable sort and ``searchsorted``
    (``bincount``'s CUDA path synchronises with the host)."""
    sorted_ids, order = torch.sort(seg_ids, stable=True)
    bounds = torch.arange(n_segments + 1, device=seg_ids.device, dtype=sorted_ids.dtype)
    offsets = torch.searchsorted(sorted_ids, bounds)
    return MembershipPlan(seg_ids, order.to(torch.int32), offsets.to(torch.int32))


def segment_reduce_plain(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Plain version: ``(onehot(seg) * w) @ values`` in fp32, the reference's
    ``kernels/ref.py:76-88``."""
    seg = seg_ids.to(device=values.device)
    onehot = (seg[None, :] == torch.arange(n_segments, device=values.device)[:, None])
    wm = onehot.to(torch.float32) * weights.to(device=values.device, dtype=torch.float32)[None, :]
    return wm @ values.to(torch.float32)


def sums_and_mass_plain(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor,
                        n_segments: int):
    """Plain version with masses: the contraction of ``[values | 1]``, split."""
    ones = torch.ones((values.shape[0], 1), dtype=torch.float32, device=values.device)
    out = segment_reduce_plain(torch.cat([values.to(torch.float32), ones], dim=1), seg_ids,
                               weights, n_segments)
    return out[:, :-1], out[:, -1]


def _workspace(device: torch.device, d: int) -> torch.Tensor:
    """The kernel's flags and done-counters: zeroed when first made
    (or grown), and left zeroed by every launch.  One a stream, so that
    launches on two streams never share it."""
    key = (device, _build.stream_ptr())
    need = 2 * (d + 1) + max(1, -(-d // 32))  # one done-counter a column tile, at least one
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < need:
        ws = _WORKSPACE[key] = torch.zeros((need,), dtype=torch.int32, device=device)
    return ws


def segment_reduce(values: torch.Tensor, members, weights: torch.Tensor, n_segments: int, *,
                   with_mass: bool = False):
    """values (K, D), members (K,) segment ids in [0, n_segments) or their
    :class:`MembershipPlan` (on the values' device), weights (K,) ->
    (n_segments, D) fp32 sums, and with ``with_mass`` also the (n_segments,)
    masses.  Given the ids alone, the card's path builds the plan on the card."""
    plan = members if isinstance(members, MembershipPlan) else None
    seg_ids = plan.seg_ids if plan is not None else members
    if plan is not None and (tuple(plan.order.shape) != tuple(seg_ids.shape)
                             or tuple(plan.offsets.shape) != (n_segments + 1,)):
        raise ValueError(f"segment_reduce: a plan of {tuple(plan.order.shape)} rows and "
                         f"{plan.offsets.numel() - 1} segments for {tuple(seg_ids.shape)} ids "
                         f"into {n_segments}")
    tensors = (values, seg_ids, weights)
    if all(t.device.type == "cpu" for t in tensors):
        if with_mass:
            return sums_and_mass_plain(values, seg_ids, weights, n_segments)
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
    if k >= 2**31 or (d + 1) * 2 >= 2**31:
        raise ValueError(f"segment_reduce: values {tuple(values.shape)} past int32 indexing")
    v = values.to(torch.float32).contiguous()
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((n_segments, d), dtype=torch.float32, device=v.device)
    mass = torch.empty((n_segments,), dtype=torch.float32, device=v.device) if with_mass else None
    if k == 0 or n_segments == 0:
        out.zero_()
        return (out, mass.zero_()) if with_mass else out
    if plan is None:
        plan = _device_plan(seg_ids, n_segments)
    for t, name, n in ((plan.order, "order", k), (plan.offsets, "offsets", n_segments + 1)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous()
                or t.device != v.device):
            raise ValueError(f"segment_reduce: plan.{name} must be contiguous int32 ({n},) on "
                             f"{v.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    ws = _workspace(v.device, d)
    f = _build.fn("segment_reduce", "rt_segment_reduce",
                  [_build.VP, _build.VP, _build.VP, _build.VP, _build.I32, _build.I32,
                   _build.I32, _build.VP, _build.VP, _build.VP, _build.VP])
    with torch.cuda.device(v.device):
        err = f(v.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(), w.data_ptr(), k, d,
                n_segments, out.data_ptr(), mass.data_ptr() if with_mass else None,
                ws.data_ptr(), _build.stream_ptr())
    _build.check(err, "segment_reduce")
    LAUNCHES["segment_reduce"] += 1
    return (out, mass) if with_mass else out
