"""Shared model primitives: RMSNorm, RoPE, GLU-MLP, embeddings.

Port of ``repro.models.layers``.  Parameter trees are declared through
:mod:`repro_torch.models.param`; activations are computed in the config
dtype, norms, rotary angles and the cross-entropy in fp32.
:class:`ShardRules` is the reference's: it names the mesh axes that
``launch.specs`` places inputs and caches on, and its ``mesh`` (a
``torch.distributed`` ``DeviceMesh``) is what the expert-parallel MoE
(``moe.moe_forward_ep``) runs over.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDecl


@dataclass(frozen=True, eq=False)
class ShardRules:
    """Maps logical dimensions to mesh axes, with divisibility fallbacks."""

    model_size: int = 16  # size of the tensor-parallel mesh axis
    batch_axes: tuple[str, ...] = ("data",)  # ("pod", "data") for multi-pod
    model_axis: str = "model"
    mesh: object = None  # a DeviceMesh: needed only by the expert-parallel MoE

    def tp(self, dim: int):
        """Tensor-parallel shard ``dim`` if divisible, else replicate."""
        return self.model_axis if dim % self.model_size == 0 else None

    @property
    def batch(self):
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_decl(d: int, dtype) -> dict:
    return {"scale": ParamDecl((d,), "ones", dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.to(torch.float32)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half
    rotation in fp32 (not interleaved), cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GLU MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_decl(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": ParamDecl((d, f), "normal", cfg.dtype),
        "up": ParamDecl((d, f), "normal", cfg.dtype),
        "down": ParamDecl((f, d), "normal", cfg.dtype),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


# ---------------------------------------------------------------------------
# token embedding + LM head
# ---------------------------------------------------------------------------


def embedding_decl(cfg: ModelConfig) -> dict:
    v, d = cfg.vocab_padded, cfg.d_model
    return {
        "embed": ParamDecl((v, d), "normal", cfg.dtype),
        "unembed": ParamDecl((d, v), "normal", cfg.dtype),
    }


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["unembed"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int, *,
                  sharded: bool = False) -> torch.Tensor:
    """Mean next-token CE over the real (unpadded) vocabulary, in fp32.

    The reference's two forms, kept as it writes them: ``sharded=False``
    adds -1e9 to the padded vocab entries and gathers the gold logit;
    ``sharded=True`` masks them to -inf and picks the gold logit with an
    index mask (on its TPU mesh that avoids an all-gather of the logits).
    Both give the same numbers."""
    v_padded = logits.shape[-1]
    if not sharded:
        logits = logits.to(torch.float32)
        pad = v_padded - vocab_size
        if pad:
            logits = logits + torch.cat([
                torch.zeros((vocab_size,), dtype=logits.dtype, device=logits.device),
                torch.full((pad,), -1e9, dtype=logits.dtype, device=logits.device)])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(logz - gold)
    iota = torch.arange(v_padded, device=logits.device)
    valid = iota < vocab_size
    x = torch.where(valid, logits.to(torch.float32), -torch.inf)
    m = torch.amax(x, dim=-1, keepdim=True)
    sumexp = torch.sum(torch.where(valid, torch.exp(x - m), 0.0), dim=-1)
    logz = torch.log(sumexp) + m[..., 0]
    gold = torch.sum(torch.where(iota == labels[..., None], x, 0.0), dim=-1)
    return torch.mean(logz - gold)
