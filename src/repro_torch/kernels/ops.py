"""Public wrappers around the port's kernels.

Port of ``repro.kernels.ops`` for the RF-TCA kernels (K1-K8), the fleet's
segment reduce (K9) and the backbone's attention (K11, its backward K11b).  Each wrapper
launches its CUDA kernel on CUDA tensors and runs the plain version on CPU
tensors.  The CUDA kernels mask their ragged edges themselves (rows past N,
columns past n, k past p), so no operand is padded here; the reference's
``_pad_to`` (and the mean padding of ``centered_gram``) has no counterpart,
and the reference's ``gram_tile_plan`` (a
TPU VMEM tiling) becomes the card's chunk plan beside the kernel wrapper,
``rff_gram_stream.gram_tile_plan``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import (
    assemble_streamed_gram,
    assemble_streamed_gram_ensemble,
)
from repro_torch.kernels import centered_gram as _centered
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rff as _rff
from repro_torch.kernels import rff_gram_stream as _gram
from repro_torch.kernels import segment_reduce as _segment


def rff(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Sigma (2N, n) from X (p, n) and Omega (N, p)."""
    return _rff.rff(x, omega)


def centered_gram(sigma: torch.Tensor) -> torch.Tensor:
    """Sigma H Sigma^T (fp32) from Sigma (2N, n)."""
    return _centered.centered_gram(sigma)


def rff_gram_stream(x: torch.Tensor, omega: torch.Tensor,
                    ell: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G_H (2N, 2N) fp32, u = Sigma ell (2N,) fp32) from X (p, n), Omega (N, p).

    Streams sample chunks through the featurize and accumulate kernels, so the
    (2N, n) RFF matrix Sigma is never materialized (peak memory O(N^2 + N b)).
    """
    gcc, gcs, gss, mc, ms = _gram.rff_gram_stream(x, omega, ell)
    # the kernels fold 1/sqrt(N) into cos/sin already: fold_n stays None
    return assemble_streamed_gram(
        gcc, gcs, gss, mc[:, 0], ms[:, 0], mc[:, 1], ms[:, 1], n=x.shape[1]
    )


def rff_fused(x: torch.Tensor, *, n_features: int, seed: int, ensemble_index: int = 0,
              sigma_rf: float = 1.0, rf_kernel: str = "gauss") -> torch.Tensor:
    """Seed-fused Sigma (2N, n) from X (p, n): no Omega operand; the weight
    rows are drawn inside the kernel from ``threefry(seed, e, row, col)``."""
    return _rff.rff_fused(x, n_features=n_features, seed=seed, ensemble_index=ensemble_index,
                          sigma=sigma_rf, rf_kernel=rf_kernel)


def rff_gram_stream_fused(x: torch.Tensor, ell: torch.Tensor, *, n_features: int, seed: int,
                          ensemble: int = 1, sigma_rf: float = 1.0,
                          rf_kernel: str = "gauss") -> tuple[torch.Tensor, torch.Tensor]:
    """Seed-fused (G_H (2N, 2N), u (2N,)) fp32 from X (p, n) and ell (n,).

    Neither the (2N, n) feature matrix nor the (N, p) weights exist: W_RF
    rows are drawn inside the kernel from the threefry stream, and ``ensemble``
    averages the statistics over S independently keyed draws.
    """
    gcc, gcs, gss, mc, ms = _gram.rff_gram_stream_fused(
        x, ell, n_features=n_features, seed=seed, ensemble=ensemble, sigma=sigma_rf,
        rf_kernel=rf_kernel,
    )
    return assemble_streamed_gram_ensemble(
        gcc, gcs, gss, mc, ms, n=x.shape[1], ensemble=ensemble
    )


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor, *,
                   n_segments: int) -> torch.Tensor:
    """Weighted segment sums ``out[e] = sum_{k: seg[k]=e} w_k * values[k]``:
    values (K, D), seg_ids (K,) ints in [0, n_segments), weights (K,) ->
    (n_segments, D) fp32.  No padding: the kernel masks its ragged edges."""
    return _segment.segment_reduce(values, seg_ids, weights, n_segments)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """(b, h, s, d) x (b, kv, s, d) x (b, kv, s, dv) -> (b, h, s, dv),
    differentiable: K11 forward, K11b backward (``FlashAttention``).  The
    reference's ``block_q``/``block_k`` (TPU tiles) have no counterpart: the
    kernel tiles by 64 and masks any ``s``."""
    return _flash.FlashAttention.apply(q, k, v, causal, window, torch.is_grad_enabled())
