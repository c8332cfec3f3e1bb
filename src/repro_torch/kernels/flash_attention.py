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
(``csrc/flash_attention.cu``); on CPU tensors it runs the plain version.  The
kernel reads any (batch, head, seq) strides with a contiguous feature axis,
so the model's (b, s, h, d) activations go in as transposed views without a
copy, and the output follows q's memory order.  ``LAUNCHES`` counts the
kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}
NEG_INF = -1e30  # the reference's masked-score sentinel
MAX_DIM = 128  # largest d or dv the kernel takes (its padded widths: 32, 64, 128)
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
    if max(d, dv) > MAX_DIM:
        raise ValueError(f"flash_attention: d {d}, dv {dv} above {MAX_DIM}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    # the output in q's memory order: (b, s, h, dv) storage for a (b, s, h, d) q
    if q.stride(1) < q.stride(2):
        out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    dp = 32 if max(d, dv) <= 32 else 64 if max(d, dv) <= 64 else 128
    f = _build.fn("flash_attention", "rt_flash_attention",
                  [_build.VP] * 4 + [_build.I32] * 8 + [_build.I64] * 12
                  + [_build.I32, _build.I32, _build.F32, _build.VP])
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], dp,
                b, h, kv, s, d, dv, *strides, int(bool(causal)), int(window),
                1.0 / math.sqrt(d), _build.stream_ptr())
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
