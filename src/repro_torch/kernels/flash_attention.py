"""Blockwise online-softmax attention with GQA, causal and window masks (K11).

Port of ``repro.kernels.flash_attention.flash_attention_pallas`` and its
wrapper ``repro.kernels.ops.flash_attention``:

    q (b, h, s, d), k (b, kv, s, d), v (b, kv, s, dv) -> (b, h, s, dv)

with query head ``i`` reading KV head ``i // (h // kv)``, scale ``1/sqrt(d)``,
keys kept where ``q_pos >= k_pos`` (causal) and ``q_pos - k_pos < window``
(``window > 0``).  Scores, softmax statistics and the PV product are fp32;
the output takes q's dtype.  fp32 and bf16 inputs, ``dv != d``, any ``s >= 1``
(the reference needs ``s`` to tile by its block).

On CUDA tensors :func:`flash_attention` launches the kernel
(``csrc/flash_attention.cu``: bf16 on the tensor cores through wgmma and
TMA, fp32 on the FFMA pipe); on CPU tensors it runs the plain version.  Any d
and dv.  The kernel reads any (batch, head, seq) strides with a contiguous
feature axis, so the model's (b, s, h, d) activations go in as transposed
views without a copy, and the output follows q's memory order.  TMA needs
16-byte aligned rows: a bf16 tensor whose base or strides are not multiples
of 16 bytes (d = 20, say) is first copied into one with its rows
zero-padded.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}
NEG_INF = -1e30  # the reference's masked-score sentinel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version: the dense masked softmax in fp32, the reference's
    oracle ``kernels/ref.py:90-110`` (``attention_ref``)."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk.to(torch.float32))
    sc = sc / (d ** 0.5)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    sc = torch.where(mask[None, None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.to(torch.float32)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (b, h, s, d)")
    b, h, s, d = q.shape
    kv = k.shape[1]
    if (k.shape != (b, kv, s, d) or v.shape[:3] != (b, kv, s) or kv == 0 or h % kv
            or s == 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k (b, kv, s, d), v (b, kv, s, dv), "
                         f"kv dividing h, s >= 1")


def _tma_strides(t: torch.Tensor) -> list[int]:
    """t's (batch, head, seq) strides, a dim of extent 1 given the stride of
    a packed layout (it is never stepped, but TMA checks it)."""
    out = []
    packed = t.shape[-1]
    for dim in (2, 1, 0):
        out.append(t.stride(dim) if t.shape[dim] > 1 else packed)
        packed = max(packed, out[-1] * t.shape[dim])
    return out[::-1]


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when TMA can load it (16-byte aligned base and strides), else
    a contiguous copy with each row zero-padded to a multiple of 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(st * size % 16 == 0 for st in _tma_strides(t)):
        return t
    width = -(-t.shape[-1] * size // 16) * 16 // size
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def bf16_plan(b: int, h: int, kv: int, s: int, d: int, dv: int) -> dict:
    """How the bf16 kernel runs a shape (for reports; loads the library):
    consumer warpgroups, keys a tile, the dv block and its chunks over the
    grid, q held in shared memory or streamed with K in d-chunks, the
    dynamic shared memory and the number of blocks."""
    out = (ctypes.c_int * 8)()
    f = _build.fn("flash_attention", "rt_flash_attention_plan",
                  [_build.I32] * 6 + [ctypes.POINTER(ctypes.c_int)])
    f(b, h, kv, s, d, dv, out)
    keys = ("warpgroups", "keys_a_tile", "dv_block", "dv_chunks", "q_resident",
            "d_blocks_an_item", "smem_bytes", "blocks")
    return dict(zip(keys, list(out)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """(b, h, s, d) x (b, kv, s, d) x (b, kv, s, dv) -> (b, h, s, dv) in q's dtype."""
    _check(q, k, v)
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
                         f"kernel takes float32 or bfloat16, all three alike")
    b, h, s, d = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    # the output in q's memory order: (b, s, h, dv) storage for a (b, s, h, d) q
    if q.stride(1) < q.stride(2):
        out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
        strides = [st for t in (q, k, v) for st in _tma_strides(t)] + list(out.stride()[:3])
    else:
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    f = _build.fn("flash_attention", "rt_flash_attention",
                  [_build.VP] * 4 + [_build.I32] * 8 + [_build.I64] * 12
                  + [_build.I32, _build.I32, _build.F32, _build.VP])
    with torch.cuda.device(q.device):
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                b, h, kv, s, q.shape[-1], v.shape[-1], dv, *strides, int(bool(causal)),
                int(window), 1.0 / math.sqrt(d), _build.stream_ptr())
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
