"""Per-client model for FedRF-TCA (paper Fig. 1):

    feature extractor G (trainable MLP)  ->  RFF compressor (fixed, shared seed)
      ->  linear aligner W_RF (2N x m)   ->  classifier C.

Port of ``repro.federated.model``.  Every piece is a plain function of a
parameter tree ``{"extractor": [{"w", "b"}, ...], "w_rf", "classifier":
{"w", "b"}}``, so the same code runs per client on the serial plane and
under ``torch.func.vmap``/``grad_and_value`` in the batched round engine.

The RFF rows here are plain torch (differentiable, batchable), as the
reference's model uses its XLA feature map and not its kernel.  Omega comes
from :func:`make_omega`: ``rff_impl="fused"`` draws it with the port's
threefry kernel (K4), the same bits as the reference's fused stream;
``"materialized"`` uses ``core.rff.draw_omega`` (a ``torch.Generator``
stream, not bit-equal to the reference's ``jax.random`` draw).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mmd import mmd_projected, mmd_projected_multi
from repro_torch.core.rff import draw_omega
from repro_torch.device import resolve_device
from repro_torch.kernels import prng


@dataclass(frozen=True)
class ClientConfig:
    input_dim: int
    n_classes: int
    extractor_widths: tuple[int, ...] = (64, 32)
    n_rff: int = 256  # N; messages are 2N floats
    m: int = 32  # aligned feature dim
    rff_sigma: float = 1.0
    rff_seed: int = 1234  # the shared seed S of Algorithm 5
    rff_impl: str = "materialized"  # or "fused": the threefry stream (K4)
    lambda_mmd: float = 1.0
    # unit-norm features (App. D-A): keeps the extractor output inside the
    # RFF kernel's resolvable scale
    normalize_features: bool = True


def make_omega(cfg: ClientConfig, *, device=None) -> torch.Tensor:
    """Shared-seed Omega (N, d): every client derives the identical matrix."""
    dev = resolve_device(device)
    if cfg.rff_impl == "fused":
        return prng.fused_omega(cfg.rff_seed, cfg.n_rff, cfg.extractor_widths[-1],
                                sigma=cfg.rff_sigma, device=dev)
    if cfg.rff_impl != "materialized":
        raise ValueError(f"unknown rff_impl {cfg.rff_impl!r}")
    return draw_omega(cfg.rff_seed, cfg.n_rff, cfg.extractor_widths[-1], sigma=cfg.rff_sigma,
                      device=dev)


def w_rf_key(seed: int) -> np.ndarray:
    """The raw uint32[2] key :func:`init_params` draws W_RF from: the
    seed-replay codec ships it (9 bytes) instead of the (2N, m) matrix.

    The key feeds a ``torch.Generator`` (:func:`draw_w_rf`), so a W_RF
    frame replayed from it decodes only in this package."""
    return np.array([seed & 0xFFFFFFFF, ((seed >> 32) ^ 0x5752_4649) & 0xFFFFFFFF], np.uint32)


def draw_w_rf(key_data, shape, *, device=None) -> torch.Tensor:
    """``normal(shape) / sqrt(shape[0])`` from a raw uint32[2] key, drawn by
    a CPU generator so every device gets the same bits."""
    k = np.asarray(key_data, dtype=np.uint64)
    gen = torch.Generator().manual_seed(int((k[0] << np.uint64(32)) | k[1]) & (2**63 - 1))
    w = torch.randn(tuple(shape), generator=gen) / math.sqrt(shape[0])
    return w.to(resolve_device(device))


def init_params(cfg: ClientConfig, seed: int, *, device=None) -> dict[str, Any]:
    """Shared initial parameters from ``seed`` (a CPU ``torch.Generator``,
    then moved to ``device``).  Not bit-equal to the reference's
    ``jax.random`` draws; ``convert.params_from_reference`` carries the
    reference's parameters over instead."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    widths = (cfg.input_dim,) + tuple(cfg.extractor_widths)
    extractor = []
    for din, dout in zip(widths[:-1], widths[1:]):
        w = torch.randn((din, dout), generator=gen) * math.sqrt(2.0 / din)
        extractor.append({"w": w.to(dev), "b": torch.zeros((dout,), device=dev)})
    w_rf = draw_w_rf(w_rf_key(seed), (2 * cfg.n_rff, cfg.m), device=dev)
    clf_w = torch.randn((cfg.m, cfg.n_classes), generator=gen) / math.sqrt(cfg.m)
    clf = {"w": clf_w.to(dev), "b": torch.zeros((cfg.n_classes,), device=dev)}
    return {"extractor": extractor, "w_rf": w_rf, "classifier": clf}


def extract(params, x_cols: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """G(X): (p, n) columns-as-samples -> (n, d_feat) rows-as-samples."""
    h = x_cols.T
    layers = params["extractor"]
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if normalize:
        h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6)
    return h


def rff_rows(h: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Sigma rows (n, 2N) = [cos(h Omega^T), sin(h Omega^T)] / sqrt(N)."""
    z = h @ omega.T
    return torch.cat([torch.cos(z), torch.sin(z)], dim=-1) / math.sqrt(omega.shape[0])


def rff_of(params, omega, x_cols):
    """Sigma rows: (n, 2N)."""
    return rff_rows(extract(params, x_cols), omega)


def client_message(params, omega, x_cols, sign: float, mask=None) -> torch.Tensor:
    """Sigma ell = sign * mean of RFF rows (eq. 2), the only data-dependent
    message a client transmits (2N floats).  ``mask`` ((n,) 0/1) restricts
    the mean to a ragged client's true columns."""
    rows = rff_of(params, omega, x_cols)
    if mask is None:
        return sign * torch.mean(rows, dim=0)
    m = mask.to(rows.dtype)
    return sign * (m @ rows) / torch.sum(m)


def logits_of(params, omega, x_cols) -> torch.Tensor:
    aligned = rff_of(params, omega, x_cols) @ params["w_rf"]
    return aligned @ params["classifier"]["w"] + params["classifier"]["b"]


def source_loss(params, omega, x, y, target_msg, cfg: ClientConfig, *, with_mmd: bool = True,
                mmd_gate=None, sample_mask=None):
    """Alg. 2: L_S = L_C + lambda L_MMD (or L_C alone when i is not in S_t).

    ``mmd_gate`` is a 0/1 tensor multiplying the MMD term (the batched
    engine's per-client membership in S_t); ``sample_mask`` ((b,) 0/1)
    marks the true columns of a ragged batch.
    """
    logits = logits_of(params, omega, x)
    per_sample = torch.log_softmax(logits, dim=-1).gather(-1, y.long()[:, None])[:, 0]
    if sample_mask is None:
        l_c = -torch.mean(per_sample)
    else:
        sm = sample_mask.to(per_sample.dtype)
        l_c = -(sm @ per_sample) / torch.sum(sm)
    if mmd_gate is None:
        if not with_mmd:
            return l_c, {"l_c": l_c, "l_mmd": torch.zeros((), device=l_c.device)}
        mmd_gate = 1.0
    msg_s = client_message(params, omega, x, +1.0, mask=sample_mask)
    l_mmd = mmd_gate * mmd_projected(params["w_rf"], msg_s, target_msg)
    return l_c + cfg.lambda_mmd * l_mmd, {"l_c": l_c, "l_mmd": l_mmd}


def target_loss(params, omega, x, source_msgs, cfg: ClientConfig, *, weights=None):
    """Alg. 3: L_T = mean over the received source messages of the pair MMD
    (11); ``weights`` (K,) restrict it to the messages that arrived."""
    msg_t = client_message(params, omega, x, -1.0)
    l_mmd = mmd_projected_multi(params["w_rf"], source_msgs, msg_t, weights=weights)
    return l_mmd, {"l_mmd": l_mmd}


def accuracy(params, omega, x, y) -> torch.Tensor:
    return torch.mean((torch.argmax(logits_of(params, omega, x), dim=-1) == y.long()).float())
