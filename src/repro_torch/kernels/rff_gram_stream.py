"""Seed-fused streamed RFF Gram (K5 and K6): one CUDA design for every N.

Port of ``repro.kernels.rff_gram_stream.rff_gram_stream_fused_pallas`` (K5,
untiled) and ``rff_gram_stream_fused_tiled_pallas`` (K6, tiled).  The TPU
split between them came from VMEM (three N^2 accumulators had to fit); on the
card the accumulators live in device memory, so ``csrc/rff_gram_stream_fused.cu``
serves both regimes.  The five-output contract is the reference's:

    G_cc = C C^T,  G_cs = C S^T,  G_ss = S S^T      (nf, nf), pooled over draws
    M_c, M_s                                         (nf, 2S): draw e's
        ell-moment in column 2e and its column sum in column 2e+1

with C, S = cos, sin(Omega_e X) / sqrt(N S), Omega_e drawn from
``threefry(seed, e, row, col)`` and never stored.

On a CUDA tensor :func:`rff_gram_stream_fused` walks X in chunks of sample
columns (:func:`gram_tile_plan`); per chunk it launches the featurize kernel
(Omega drawn in the kernel), the moment kernel and the Gram accumulate kernel.  On a CPU tensor it
runs :func:`rff_gram_stream_fused_plain`.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prng import _KINDS, _MASK, _inv_sigma, fused_omega_block_plain
from repro_torch.kernels.rff import inv_sqrt

LAUNCHES = {"featurize": 0, "moments": 0, "accumulate": 0}

FEATURIZE_COLS = 256  # featurize.cuh FZ_BN: chunk widths are multiples of it
# The workspace holds one chunk's cos and sin slabs, (nf, S * block) each.
WORKSPACE_BYTES = 64 << 20


def feature_scale(n_features: int, ensemble: int) -> float:
    """f32 1/sqrt(N) (times f32 1/sqrt(S) for S > 1), as the reference folds it."""
    inv = np.float32(inv_sqrt(n_features))
    if ensemble > 1:
        inv = np.float32(inv * np.float32(1.0 / np.sqrt(np.float32(ensemble))))
    return float(inv)


def rff_gram_stream_fused_plain(x, ell, *, n_features, seed, ensemble=1, sigma=1.0,
                                rf_kernel="gauss"):
    """Plain version: the five outputs from materialized per-draw Omega.

    ``x`` (p, n), ``ell`` (n,) -> (gcc, gcs, gss (nf, nf), mc, ms (nf, 2S)).
    """
    p, n = x.shape
    nf = n_features
    inv = feature_scale(nf, ensemble)
    gcc = torch.zeros((nf, nf), dtype=torch.float32, device=x.device)
    gcs = torch.zeros_like(gcc)
    gss = torch.zeros_like(gcc)
    mc = torch.zeros((nf, 2 * ensemble), dtype=torch.float32, device=x.device)
    ms = torch.zeros_like(mc)
    for e in range(ensemble):
        om = fused_omega_block_plain(
            seed, nf, p, ensemble_index=e, sigma=sigma, rf_kernel=rf_kernel,
            device=x.device,
        )
        z = om @ x
        c = torch.cos(z) * inv
        s = torch.sin(z) * inv
        gcc += c @ c.T
        gcs += c @ s.T
        gss += s @ s.T
        mc[:, 2 * e] = c @ ell
        mc[:, 2 * e + 1] = c.sum(dim=1)
        ms[:, 2 * e] = s @ ell
        ms[:, 2 * e + 1] = s.sum(dim=1)
    return gcc, gcs, gss, mc, ms


def gram_tile_plan(n_features: int, *, n: int, ensemble: int = 1) -> dict:
    """The fused Gram's chunking on the card for N features, n samples, S draws.

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


def _mirror_upper(g: torch.Tensor) -> torch.Tensor:
    """The accumulate kernel fills the upper tiles of a symmetric block."""
    return torch.triu(g) + torch.triu(g, 1).T


def rff_gram_stream_fused(x, ell, *, n_features, seed, ensemble=1, sigma=1.0,
                          rf_kernel="gauss"):
    """Seed-fused five outputs from X (p, n) and ell (n,).

    The workspace holds one chunk's (nf, S block) cos and sin slabs, with
    ``block`` from :func:`gram_tile_plan`.  CUDA tensors launch the kernels;
    CPU tensors run the plain version.
    """
    if rf_kernel not in _KINDS:
        raise ValueError(f"unknown rf kernel {rf_kernel!r}")
    if x.device.type == "cpu" and ell.device.type == "cpu":
        return rff_gram_stream_fused_plain(
            x, ell, n_features=n_features, seed=seed, ensemble=ensemble, sigma=sigma,
            rf_kernel=rf_kernel,
        )
    if not (x.is_cuda and ell.is_cuda) or x.device != ell.device:
        raise ValueError(f"rff_gram_stream_fused: x on {x.device}, ell on {ell.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 (p, n), got {x.dtype} {tuple(x.shape)}")
    p, n = x.shape
    if ell.dtype != torch.float32 or tuple(ell.shape) != (n,) or not ell.is_contiguous():
        raise ValueError(f"ell: expected contiguous float32 ({n},), got {tuple(ell.shape)}")
    nf, draws = n_features, ensemble
    block = gram_tile_plan(nf, n=n, ensemble=draws)["block"]
    dev = x.device
    ws_c = torch.empty((nf, draws * block), dtype=torch.float32, device=dev)
    ws_s = torch.empty_like(ws_c)
    gcc = torch.zeros((nf, nf), dtype=torch.float32, device=dev)
    gcs = torch.zeros_like(gcc)
    gss = torch.zeros_like(gcc)
    mc = torch.zeros((nf, 2 * draws), dtype=torch.float32, device=dev)
    ms = torch.zeros_like(mc)
    vp, i32, f32 = _build.VP, _build.I32, _build.F32
    featurize = _build.fn(
        "rff_gram_stream_fused", "rt_fused_featurize",
        [_build.U32, f32, i32, vp, _build.I64] + [i32] * 6 + [f32, vp, vp, vp],
    )
    moments = _build.fn("rff_gram_stream_fused", "rt_gram_moments",
                        [vp, vp, i32, i32, i32, vp, i32, vp, vp, vp])
    accumulate = _build.fn("rff_gram_stream_fused", "rt_gram_accumulate",
                           [vp, vp, i32, i32, vp, vp, vp, vp])
    scale = feature_scale(nf, draws)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr()
        for c0 in range(0, n, block):
            n_valid = min(block, n - c0)
            err = featurize(seed & _MASK, _inv_sigma(sigma), _KINDS[rf_kernel],
                            x.data_ptr(), n, c0, nf, p, n_valid, block, draws, scale,
                            ws_c.data_ptr(), ws_s.data_ptr(), stream)
            _build.check(err, "fused featurize")
            LAUNCHES["featurize"] += 1
            err = moments(ws_c.data_ptr(), ws_s.data_ptr(), nf, draws, block,
                          ell.data_ptr() + 4 * c0, n_valid, mc.data_ptr(), ms.data_ptr(),
                          stream)
            _build.check(err, "gram moments")
            LAUNCHES["moments"] += 1
            err = accumulate(ws_c.data_ptr(), ws_s.data_ptr(), nf, draws * block,
                             gcc.data_ptr(), gcs.data_ptr(), gss.data_ptr(), stream)
            _build.check(err, "gram accumulate")
            LAUNCHES["accumulate"] += 1
    return _mirror_upper(gcc), gcs, _mirror_upper(gss), mc, ms
