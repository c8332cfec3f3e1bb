"""Streamed RFF Gram (K2/K3 and K5/K6): one CUDA design for every N.

Port of ``repro.kernels.rff_gram_stream``: ``rff_gram_stream_pallas`` (K2)
and ``rff_gram_stream_tiled_pallas`` (K3), which read Omega from an operand,
and ``rff_gram_stream_fused_pallas`` (K5) and
``rff_gram_stream_fused_tiled_pallas`` (K6), which draw it inside the kernel.
The TPU's untiled/tiled split came from VMEM (three N^2 accumulators had to
fit); on the card the accumulators live in device memory, so
``csrc/rff_gram_stream_fused.cu`` serves every N for both Omega sources.  The
five-output contract is the reference's:

    G_cc = C C^T,  G_cs = C S^T,  G_ss = S S^T      (nf, nf), pooled over draws
    M_c, M_s                                         (nf, 2S): draw e's
        ell-moment in column 2e and its column sum in column 2e+1

with C, S = cos, sin(Omega_e X) / sqrt(N S) (S = 1 on the operand path) and
Omega_e either the (N, p) operand or drawn from ``threefry(seed, e, row,
col)`` and never stored.

On CUDA tensors :func:`rff_gram_stream` and :func:`rff_gram_stream_fused`
walk X in chunks of sample columns (:func:`gram_tile_plan`); per chunk they
launch a featurize kernel (Omega loaded by TMA, or drawn in the kernel), the
moment kernel and the Gram accumulate kernel.  Both paths run both products
on the tensor cores as three tf32 products each
(``csrc/featurize_tf32.cuh``, ``csrc/gram_tf32.cuh``).  On CPU tensors they
run :func:`rff_gram_stream_plain` and :func:`rff_gram_stream_fused_plain`.
``LAUNCHES`` (seed-fused, K5/K6) and ``OPERAND_LAUNCHES`` (Omega operand,
K2/K3) count the launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prng import _KINDS, _MASK, _inv_sigma, fused_omega_block_plain
from repro_torch.kernels.rff import counter_ptr, inv_sqrt, tma_rows

LAUNCHES = {"featurize": 0, "moments": 0, "accumulate": 0}
OPERAND_LAUNCHES = {"featurize": 0, "moments": 0, "accumulate": 0}

# chunk widths are multiples of it: two of featurize_tf32.cuh's FT_COLS, the
# sample columns of one CTA of the tensor-core featurize (both Omega sources)
FEATURIZE_COLS = 256
# The workspace holds one chunk's cos and sin slabs, (nf, S * block) each.
WORKSPACE_BYTES = 64 << 20


def feature_scale(n_features: int, ensemble: int) -> float:
    """f32 1/sqrt(N) (times f32 1/sqrt(S) for S > 1), as the reference folds it."""
    inv = np.float32(inv_sqrt(n_features))
    if ensemble > 1:
        inv = np.float32(inv * np.float32(1.0 / np.sqrt(np.float32(ensemble))))
    return float(inv)


def _slab_stats(om: torch.Tensor, x: torch.Tensor, ell: torch.Tensor, inv: float):
    """One draw's contribution: (C C^T, C S^T, S S^T, [C ell, C 1], [S ell, S 1])."""
    z = om @ x
    c = torch.cos(z) * inv
    s = torch.sin(z) * inv
    mc = torch.stack([c @ ell, c.sum(dim=1)], dim=1)
    ms = torch.stack([s @ ell, s.sum(dim=1)], dim=1)
    return c @ c.T, c @ s.T, s @ s.T, mc, ms


def rff_gram_stream_plain(x, omega, ell):
    """Plain version of :func:`rff_gram_stream`: ``x`` (p, n), ``omega``
    (N, p), ``ell`` (n,) -> (gcc, gcs, gss (N, N), mc, ms (N, 2))."""
    return _slab_stats(omega, x, ell, feature_scale(omega.shape[0], 1))


def rff_gram_stream_fused_plain(x, ell, *, n_features, seed, ensemble=1, sigma=1.0,
                                rf_kernel="gauss"):
    """Plain version: the five outputs from materialized per-draw Omega.

    ``x`` (p, n), ``ell`` (n,) -> (gcc, gcs, gss (nf, nf), mc, ms (nf, 2S)).
    """
    p = x.shape[0]
    inv = feature_scale(n_features, ensemble)
    parts = [
        _slab_stats(fused_omega_block_plain(seed, n_features, p, ensemble_index=e, sigma=sigma,
                                            rf_kernel=rf_kernel, device=x.device), x, ell, inv)
        for e in range(ensemble)
    ]
    gcc, gcs, gss = (sum(part[i] for part in parts) for i in range(3))
    mc = torch.cat([part[3] for part in parts], dim=1)
    ms = torch.cat([part[4] for part in parts], dim=1)
    return gcc, gcs, gss, mc, ms


def gram_tile_plan(n_features: int, *, n: int, ensemble: int = 1) -> dict:
    """The streamed Gram's chunking on the card for N features, n samples, S draws.

    ``block``: sample columns per chunk, a multiple of ``FEATURIZE_COLS``, as
    wide as ``WORKSPACE_BYTES`` allows (fewer chunks mean fewer
    read-modify-writes of the three N^2 accumulators) and balanced so the
    last chunk is not mostly masked.  Returns ``{"block", "chunks",
    "workspace_bytes"}``.
    """
    step = FEATURIZE_COLS
    per_col = 2 * n_features * ensemble * 4
    cap = max(step, (WORKSPACE_BYTES // per_col) // step * step)
    chunks = max(1, -(-n // cap))
    block = -(-(-(-n // chunks)) // step) * step
    return {"block": block, "chunks": -(-n // block), "workspace_bytes": per_col * block}


def mirror_upper(g: torch.Tensor) -> torch.Tensor:
    """The Gram kernels fill the upper tiles of a symmetric block."""
    return torch.triu(g) + torch.triu(g, 1).T


def _check_operands(name: str, x: torch.Tensor, ell: torch.Tensor) -> bool:
    """True for CPU operands (the plain version runs); raises on what the
    kernels do not take."""
    if x.device.type == "cpu" and ell.device.type == "cpu":
        return True
    if not (x.is_cuda and ell.is_cuda) or x.device != ell.device:
        raise ValueError(f"{name}: x on {x.device}, ell on {ell.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 (p, n), got {x.dtype} {tuple(x.shape)}")
    n = x.shape[1]
    if ell.dtype != torch.float32 or tuple(ell.shape) != (n,) or not ell.is_contiguous():
        raise ValueError(f"ell: expected contiguous float32 ({n},), got {tuple(ell.shape)}")
    return False


def _stream(x, ell, nf: int, draws: int, featurize, counts: dict):
    """The chunk loop on the card: per chunk of sample columns,
    ``featurize(c0, n_valid, block, ws_c, ws_s, stream)`` fills the cos/sin
    workspace, then the moment kernel and the accumulate kernel add into the
    outputs.  The accumulate multiplies each row of its first operand less
    that draw's mean over the first chunk (from the moments) and, at the last
    chunk, adds the shifts back from the moments' column sums.  Returns the
    five outputs with G_cc and G_ss mirrored."""
    n = x.shape[1]
    block = gram_tile_plan(nf, n=n, ensemble=draws)["block"]
    dev = x.device
    ws_c = torch.empty((nf, draws * block), dtype=torch.float32, device=dev)
    ws_s = torch.empty_like(ws_c)
    gcc = torch.zeros((nf, nf), dtype=torch.float32, device=dev)
    gcs = torch.zeros_like(gcc)
    gss = torch.zeros_like(gcc)
    mc = torch.zeros((nf, 2 * draws), dtype=torch.float32, device=dev)
    ms = torch.zeros_like(mc)
    vp, i32 = _build.VP, _build.I32
    moments = _build.fn("rff_gram_stream_fused", "rt_gram_moments",
                        [vp, vp, i32, i32, i32, vp, i32, vp, vp, vp])
    accumulate = _build.fn("rff_gram_stream_fused", "rt_fused_gram_accumulate",
                           [vp, vp, i32, i32, i32] + [vp] * 8)
    shifts = None
    with torch.cuda.device(dev):
        stream = _build.stream_ptr()
        for c0 in range(0, n, block):
            n_valid = min(block, n - c0)
            _build.check(featurize(c0, n_valid, block, ws_c, ws_s, stream), "gram featurize")
            counts["featurize"] += 1
            err = moments(ws_c.data_ptr(), ws_s.data_ptr(), nf, draws, block,
                          ell.data_ptr() + 4 * c0, n_valid, mc.data_ptr(), ms.data_ptr(),
                          stream)
            _build.check(err, "gram moments")
            counts["moments"] += 1
            if shifts is None:
                # (nf, S): each row's mean over this chunk's valid columns, per draw
                shifts = tuple((m[:, 1::2] / n_valid).contiguous() for m in (mc, ms))
            last = c0 + block >= n
            err = accumulate(ws_c.data_ptr(), ws_s.data_ptr(), nf, draws * block, block,
                             gcc.data_ptr(), gcs.data_ptr(), gss.data_ptr(),
                             shifts[0].data_ptr(), shifts[1].data_ptr(),
                             mc.data_ptr() if last else None, ms.data_ptr() if last else None,
                             stream)
            _build.check(err, "gram accumulate")
            counts["accumulate"] += 1
    return mirror_upper(gcc), gcs, mirror_upper(gss), mc, ms


def rff_gram_stream(x, omega, ell, *, counters=None):
    """Five outputs from X (p, n), Omega (N, p) and ell (n,); moments (N, 2).

    CUDA tensors launch the kernels (Omega read from the operand); CPU tensors
    run the plain version.  ``counters`` (CUDA only): as
    :func:`repro_torch.kernels.rff.counter_ptr` says, of which the featurize
    adds to the phases recomputed only (nothing is drawn).
    """
    if _check_operands("rff_gram_stream", x, ell) and omega.device.type == "cpu":
        return rff_gram_stream_plain(x, omega, ell)
    if omega.device != x.device:
        raise ValueError(f"rff_gram_stream: x on {x.device}, omega on {omega.device}")
    p = x.shape[0]
    if omega.dtype != torch.float32 or omega.ndim != 2 or not omega.is_contiguous() \
            or omega.shape[1] != p:
        raise ValueError(f"omega: expected contiguous float32 (N, {p}), got {omega.dtype} "
                         f"{tuple(omega.shape)}")
    nf = omega.shape[0]
    f = _build.fn("rff_gram_stream_fused", "rt_operand_featurize",
                  [_build.VP, _build.I64, _build.VP, _build.I64] + [_build.I32] * 5
                  + [_build.F32] + [_build.VP] * 4)
    scale = feature_scale(nf, 1)
    xr, omr = tma_rows(x), tma_rows(omega)
    stats = counter_ptr(counters)

    def featurize(c0, n_valid, block, ws_c, ws_s, stream):
        return f(omr.data_ptr(), omr.shape[1], xr.data_ptr(), xr.shape[1], c0, nf, p, n_valid,
                 block, scale, ws_c.data_ptr(), ws_s.data_ptr(), stats, stream)

    return _stream(x, ell, nf, 1, featurize, OPERAND_LAUNCHES)


def rff_gram_stream_fused(x, ell, *, n_features, seed, ensemble=1, sigma=1.0,
                          rf_kernel="gauss", counters=None):
    """Seed-fused five outputs from X (p, n) and ell (n,).

    The workspace holds one chunk's (nf, S block) cos and sin slabs, with
    ``block`` from :func:`gram_tile_plan`.  CUDA tensors launch the kernels;
    CPU tensors run the plain version.  ``counters`` (CUDA only) sums the
    featurize launches' counts, as :func:`repro_torch.kernels.rff.counter_ptr`
    says.
    """
    if rf_kernel not in _KINDS:
        raise ValueError(f"unknown rf kernel {rf_kernel!r}")
    if _check_operands("rff_gram_stream_fused", x, ell):
        return rff_gram_stream_fused_plain(
            x, ell, n_features=n_features, seed=seed, ensemble=ensemble, sigma=sigma,
            rf_kernel=rf_kernel,
        )
    p, n = x.shape
    f = _build.fn(
        "rff_gram_stream_fused", "rt_fused_featurize",
        [_build.U32, _build.F32, _build.I32, _build.VP, _build.I64] + [_build.I32] * 6
        + [_build.F32, _build.VP, _build.VP, _build.VP, _build.VP],
    )
    scale = feature_scale(n_features, ensemble)
    xr = tma_rows(x)
    stats = counter_ptr(counters)

    def featurize(c0, n_valid, block, ws_c, ws_s, stream):
        return f(seed & _MASK, _inv_sigma(sigma), _KINDS[rf_kernel], xr.data_ptr(), xr.shape[1],
                 c0, n_features, p, n_valid, block, ensemble, scale, ws_c.data_ptr(),
                 ws_s.data_ptr(), stats, stream)

    return _stream(x, ell, n_features, ensemble, featurize, LAUNCHES)
