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
zero-padded.

Training goes through :class:`FlashAttention`, a ``torch.autograd.Function``.
Its forward asks the kernel for two more outputs, each row's log-sum-exp
``lse`` (b, h, s) and the fp32 output before its rounding to q's dtype; its
backward is K11b (``csrc/flash_attention_bwd.cu``, on CUDA tensors: bf16 on
the tensor cores through wgmma and TMA, fp32 on the FFMA pipe) or
:func:`flash_attention_backward_plain` (on CPU tensors).  The reference
has no backward kernel: it differentiates its jnp scan.  ``LAUNCHES``
counts the forward kernel's launches and the backward calls (one a call,
whatever kernels it runs).

On meta tensors (a dry run: ``launch.dryrun``) each wrapper returns empty
outputs of the kernel's shapes and dtypes and runs nothing, not even the
plain version, whose (s, s) scores are work the kernel never does.  Each
wrapper has a ``cost(shape, dtype, causal, window)`` giving the (flops,
bytes) of one call at ``shape = (b, h, kv, s, d, dv)``: the products over
the causal or window band and each input read and each output written
once.  Every call on meta or CUDA tensors adds its cost to ``COST``, so a
roofline (``launch.roofline.from_step``) reads the same work whether the
kernel or its meta stand-in ran.  On CPU tensors nothing is added: the
plain version's own operations are what runs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
COST = {name: {"calls": 0, "flops": 0, "bytes": 0} for name in LAUNCHES}
NEG_INF = -1e30  # the reference's masked-score sentinel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _keep_mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """Masked scaled scores in fp32, (b, h, s, s), k repeated over its group."""
    d, s = q.shape[-1], q.shape[2]
    kk = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk.to(torch.float32))
    sc = sc / (d ** 0.5)
    return torch.where(_keep_mask(s, causal, window, q.device)[None, None], sc,
                       torch.full_like(sc, NEG_INF))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, return_lse: bool = False):
    """Plain version: the dense masked softmax in fp32, the reference's
    oracle ``kernels/ref.py:90-110`` (``attention_ref``).  With
    ``return_lse`` also each row's log-sum-exp of its scores, (b, h, s)
    fp32, and the fp32 output before the rounding to q's dtype."""
    sc = _scores(q, k, causal, window)
    p = torch.softmax(sc, dim=-1)
    vv = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv.to(torch.float32))
    if return_lse:
        return o.to(q.dtype), torch.logsumexp(sc, dim=-1), o
    return o.to(q.dtype)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                   causal: bool = True, window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` in the inputs' dtype, from the
    forward's fp32 output ``o`` and ``lse``: the formulas of K11b in fp32,

        D = rowsum(dO o),  P = exp(S / sqrt(d) - lse),  dP = dO V^T,
        dS = P (dP - D),  dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d),
        dV = P^T dO,

    dK and dV summed over the g = h / kv query heads of each KV head."""
    b, h, s, d = q.shape
    kv, g = k.shape[1], h // k.shape[1]
    f32 = torch.float32
    dof = do.to(f32)
    delta = torch.sum(dof * o.to(f32), dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, causal, window) - lse.to(f32)[..., None])
    dp = torch.einsum("bhqc,bhkc->bhqk", dof,
                      v.repeat_interleave(g, dim=1).to(f32))
    ds = p * (dp - delta)
    scale = 1.0 / (d ** 0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.repeat_interleave(g, dim=1).to(f32)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32)) * scale
    dv = torch.einsum("bhqk,bhqc->bhkc", p, dof)
    dk = dk.reshape(b, kv, g, s, d).sum(dim=2)
    dv = dv.reshape(b, kv, g, s, v.shape[-1]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def bwd_bf16_plan(d: int, dv: int) -> dict:
    """How K11b's bf16 kernels run widths d and dv (for reports; loads the
    library): consumer warpgroups, stages of the ring, bf16 parts of P and
    dS, the dK/dV and dQ kernels' output chunks over the grid, the dynamic
    shared memory.  Raises where the widths do not fit, as the backward does."""
    out = (ctypes.c_int * 6)()
    f = _build.fn("flash_attention_bwd", "rt_flash_attention_bwd_plan",
                  [_build.I32, _build.I32, ctypes.POINTER(ctypes.c_int)])
    _build.check(f(d, dv, out), f"flash_attention_bwd_plan (d {d}, dv {dv})")
    keys = ("warpgroups", "stages", "p_ds_parts", "dkdv_chunks", "dq_chunks", "smem_bytes")
    return dict(zip(keys, list(out)))


def band_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of an (s, s) score matrix that the mask keeps:
    ``q_pos >= k_pos`` if causal, ``q_pos - k_pos < window`` if window."""
    w = min(window, s) if window else 0
    if causal:
        return w * (w + 1) // 2 + (s - w) * w if w else s * (s + 1) // 2
    if not w:
        return s * s
    # row i keeps keys j >= i - w + 1: all s for i < w, s - (i - w + 1) after
    n = s - w
    return w * s + n * s - n * (n + 1) // 2


def forward_cost(shape, dtype, causal: bool = True, window: int = 0, *,
                 return_lse: bool = False) -> tuple[int, int]:
    """(flops, bytes) of one K11 call at ``shape = (b, h, kv, s, d, dv)``:
    QK^T and PV over the band (2 flops a multiply-add), q, k, v read and o
    written once in ``dtype``; with ``return_lse`` also the fp32 lse and,
    below fp32, the fp32 output."""
    b, h, kv, s, d, dv = shape
    e = dtype.itemsize
    flops = 2 * b * h * band_pairs(s, causal, window) * (d + dv)
    nbytes = e * (b * h * s * (d + dv) + b * kv * s * (d + dv))
    if return_lse:
        nbytes += 4 * b * h * s + (4 * b * h * s * dv if e != 4 else 0)
    return flops, nbytes


def backward_cost(shape, dtype, causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one K11b call: the five band products (S = QK^T,
    dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q), q, k, v, do read and
    dq, dk, dv written once in ``dtype``, the fp32 o and lse read once."""
    b, h, kv, s, d, dv = shape
    e = dtype.itemsize
    flops = 2 * b * h * band_pairs(s, causal, window) * (3 * d + 2 * dv)
    nbytes = e * (b * h * s * (2 * d + dv) + 2 * b * kv * s * (d + dv)) + 4 * (
        b * h * s * dv + b * h * s)
    return flops, nbytes


def training_cost(shape, dtype, causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one training attention: K11 with lse, then K11b."""
    fwd = forward_cost(shape, dtype, causal, window, return_lse=True)
    bwd = backward_cost(shape, dtype, causal, window)
    return fwd[0] + bwd[0], fwd[1] + bwd[1]


def _record(name: str, cost: tuple[int, int]) -> None:
    COST[name]["calls"] += 1
    COST[name]["flops"] += int(cost[0])
    COST[name]["bytes"] += int(cost[1])


def _placement(what: str, tensors) -> str:
    """"cpu" (the plain version runs), "meta" (a dry run: empty outputs) or
    "cuda" (the kernel, all tensors on one device); raises on a mix."""
    for kind in ("cpu", "meta"):
        if all(t.device.type == kind for t in tensors):
            return kind
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on " + ", ".join(str(t.device) for t in tensors))
    return "cuda"


def _out_like(q: torch.Tensor, b: int, h: int, s: int, width: int, dtype) -> torch.Tensor:
    """An uninitialised (b, h, s, width) tensor in q's memory order: (b, s,
    h, width) storage for a (b, s, h, d) q seen heads-first."""
    if q.stride(1) < q.stride(2):
        return torch.empty((b, s, h, width), dtype=dtype, device=q.device).transpose(1, 2)
    return torch.empty((b, h, s, width), dtype=dtype, device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """(b, h, s, d) x (b, kv, s, d) x (b, kv, s, dv) -> (b, h, s, dv) in q's dtype.

    With ``return_lse``: (o, lse, o_acc), ``lse`` each row's log-sum-exp of
    its scaled scores (b, h, s) fp32 and ``o_acc`` the fp32 output before
    the rounding to q's dtype (``o`` itself at fp32), as the backward needs
    them.  Without it the kernel writes neither (the serve path's launch)."""
    _check(q, k, v)
    place = _placement("flash_attention", (q, k, v))
    if place == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
                         f"kernel takes float32 or bfloat16, all three alike")
    b, h, s, d = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = _out_like(q, b, h, s, dv, q.dtype)
    lse = o_acc = None
    if return_lse:
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        o_acc = out if q.dtype == torch.float32 else torch.empty(
            (b, h, s, dv), dtype=torch.float32, device=q.device)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
        strides = [st for t in (q, k, v) for st in _tma_strides(t)] + list(out.stride()[:3])
    else:
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    cost = forward_cost((b, h, kv, s, d, dv), q.dtype, causal, window, return_lse=return_lse)
    if place == "meta":
        _record("flash_attention", cost)
        return (out, lse, o_acc) if return_lse else out
    f = _build.fn("flash_attention", "rt_flash_attention",
                  [_build.VP] * 4 + [_build.I32] * 8 + [_build.I64] * 12
                  + [_build.I32, _build.I32, _build.F32, _build.VP, _build.VP, _build.VP])
    acc_ptr = o_acc.data_ptr() if o_acc is not None and o_acc is not out else None
    with torch.cuda.device(q.device):
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                b, h, kv, s, q.shape[-1], v.shape[-1], dv, *strides, int(bool(causal)),
                int(window), 1.0 / math.sqrt(d), None if lse is None else lse.data_ptr(),
                acc_ptr, _build.stream_ptr())
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    _record("flash_attention", cost)
    if return_lse:
        return out, lse, o_acc
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o_acc: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """(dq, dk, dv) in the inputs' dtype and memory order, from the forward's
    ``lse`` and fp32 output ``o_acc`` and the output's gradient ``do``.  On
    CUDA tensors K11b: D = rowsum(do o_acc), then dK and dV (one block a key
    block and KV head, summing its group's query heads in the block: no
    atomics), then dQ; bf16 on the tensor cores (wgmma fed by TMA, P and dS
    in bf16 parts; TMA reads q, k, v and do as the forward reads its
    inputs, rows padded to 16 bytes where it needs that; widths that fit
    the shared memory, ``bwd_bf16_plan``), fp32 on the FFMA pipe (any
    widths).  On CPU
    tensors the plain version."""
    _check(q, k, v)
    tensors = (q, k, v, o_acc, lse, do)
    place = _placement("flash_attention_backward", tensors)
    if place == "cpu":
        return flash_attention_backward_plain(q, k, v, o_acc, lse, do, causal=causal,
                                              window=window)
    b, h, s, d = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if (o_acc.dtype != torch.float32 or o_acc.shape != (b, h, s, dv)
            or lse.dtype != torch.float32 or lse.shape != (b, h, s) or do.shape != (b, h, s, dv)):
        raise ValueError(f"flash_attention_backward: o_acc {o_acc.dtype} {tuple(o_acc.shape)}, "
                         f"lse {lse.dtype} {tuple(lse.shape)}, do {tuple(do.shape)}: need fp32 "
                         f"(b, h, s, dv), fp32 (b, h, s) and (b, h, s, dv)")
    if window < 0:
        raise ValueError(f"flash_attention_backward: window {window} < 0")
    do = do.to(q.dtype)
    q, k, v, o_acc, do = (t if t.stride(-1) == 1 else t.contiguous()
                          for t in (q, k, v, o_acc, do))
    lse = lse.contiguous()
    dq = _out_like(q, b, h, s, d, q.dtype)
    dk = _out_like(k, b, kv, s, d, k.dtype)
    dvv = _out_like(v, b, kv, s, dv, v.dtype)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    strides = [st for t in (q, k, v, o_acc, do, dq, dk, dvv) for st in _tma_strides(t)]
    cost = backward_cost((b, h, kv, s, d, dv), q.dtype, causal, window)
    if place == "meta":
        _record("flash_attention_bwd", cost)
        return dq, dk, dvv
    f = _build.fn("flash_attention_bwd", "rt_flash_attention_bwd",
                  [_build.VP] * 10 + [_build.I32] * 7 + [_build.I64] * 24
                  + [_build.I32, _build.I32, _build.F32, _build.VP])
    with torch.cuda.device(q.device):
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_acc.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
                _DTYPES[q.dtype], b, h, kv, s, d, dv, *strides, int(bool(causal)), int(window),
                1.0 / math.sqrt(d), _build.stream_ptr())
    _build.check(err, f"flash_attention_bwd ({q.dtype}, d {d}, dv {dv})")
    LAUNCHES["flash_attention_bwd"] += 1
    _record("flash_attention_bwd", cost)
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """K11 with K11b as its backward: ``apply(q, k, v, causal, window,
    train)``.  With ``train`` (grad mode on) and an input that needs a
    gradient, the forward keeps q, k, v, lse and the fp32 output for the
    backward; otherwise it is the serve path's launch.  ``cost`` is a
    training call's: K11 with lse, then K11b."""

    cost = staticmethod(training_cost)

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, train: bool):
        ctx.causal, ctx.window = causal, window
        if not (train and any(ctx.needs_input_grad[:3])):
            return flash_attention(q, k, v, causal=causal, window=window)
        out, lse, o_acc = flash_attention(q, k, v, causal=causal, window=window,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, o_acc, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o_acc, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o_acc, lse, do, causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None, None


flash_attention.cost = forward_cost
flash_attention_backward.cost = backward_cost
