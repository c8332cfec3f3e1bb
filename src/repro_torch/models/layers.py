"""Shared model primitives: RMSNorm, RoPE, GLU-MLP, embeddings.

Port of ``repro.models.layers``.  Parameter trees are declared through
:mod:`repro_torch.models.param`; activations are computed in the config
dtype, norms, rotary angles and the cross-entropy in fp32.
:class:`ShardRules` is the reference's: every declaration takes it and
places its tensor by ``ShardRules.tp``, and its ``mesh`` (a
``torch.distributed`` ``DeviceMesh``) is what ``LM`` runs SPMD over.  The
functions take a ``par`` (``models.parallel.Par``, this rank's view of the
mesh; ``None``: one rank): the MLP is column-parallel in gate and up and
row-parallel in down, the embedding (sharded on d) is gathered over the
model axis after the lookup, the logits stay sharded on the vocabulary, and
the cross-entropy's two forms both run on them.
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
    mesh: object = None  # a DeviceMesh: the LM runs SPMD over it (models.parallel)

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
    return {"scale": ParamDecl((d,), "ones", dtype, spec=(None,))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5, par=None) -> torch.Tensor:
    """RMSNorm over the last dimension; ``par``: x may be a sequence shard
    (``Par.norm_scale``)."""
    scale = params["scale"] if par is None else par.norm_scale(params["scale"])
    h = x.to(torch.float32)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * scale.to(torch.float32)).to(x.dtype)


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


def mlp_decl(cfg: ModelConfig, rules: ShardRules | None = None,
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ff_spec = (rules or ShardRules()).tp(f)
    return {
        "gate": ParamDecl((d, f), "normal", cfg.dtype, spec=(None, ff_spec)),
        "up": ParamDecl((d, f), "normal", cfg.dtype, spec=(None, ff_spec)),
        "down": ParamDecl((f, d), "normal", cfg.dtype, spec=(ff_spec, None)),
    }


def mlp_local(params, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU on whatever part of d_ff this rank holds (partial sums
    where it is a shard)."""
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def mlp(params, x: torch.Tensor, par=None, d_ff: int = 0) -> torch.Tensor:
    """x on the residual's layout; ``d_ff``: the global width, which decides
    (``Par.shards``) whether ``params`` are column/row shards."""
    if par is None:
        return mlp_local(params, x)
    sharded = par.shards(d_ff)
    return par.leave(mlp_local(params, par.enter(x, sharded)), partial=sharded)


# ---------------------------------------------------------------------------
# token embedding + LM head
# ---------------------------------------------------------------------------


def embedding_decl(cfg: ModelConfig, rules: ShardRules | None = None) -> dict:
    v, d = cfg.vocab_padded, cfg.d_model
    rules = rules or ShardRules()
    return {
        # embed sharded along d_model: the row lookup stays local, a small all-gather
        "embed": ParamDecl((v, d), "normal", cfg.dtype, spec=(None, rules.tp(d))),
        # unembed sharded along the vocabulary: the logits stay sharded into the CE
        "unembed": ParamDecl((d, v), "normal", cfg.dtype, spec=(None, rules.tp(v))),
    }


def embed(params, tokens: torch.Tensor, par=None, d: int = 0) -> torch.Tensor:
    """The rows of ``tokens``; with ``par`` and a width ``d`` the model axis
    shards, this rank's d-shard of each row gathered over the model axis
    (replicated output)."""
    x = params["embed"][tokens]
    if par is not None and par.shards(d):
        x = par.gather_rep(x, -1)
    return x


def unembed(params, x: torch.Tensor, par=None, vocab: int = 0) -> torch.Tensor:
    """Logits; with ``par`` and a vocabulary ``vocab`` the model axis shards,
    this rank's vocabulary shard of them (x replicated)."""
    if par is not None and par.shards(vocab):
        x = par.copy(x)
    return x @ params["unembed"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int, *,
                  sharded: bool = False, par=None) -> torch.Tensor:
    """Mean next-token CE over the real (unpadded) vocabulary, in fp32.

    The reference's two forms, kept as it writes them: ``sharded=False``
    adds -1e9 to the padded vocab entries and gathers the gold logit;
    ``sharded=True`` masks them to -inf and picks the gold logit with an
    index mask (on its TPU mesh that avoids an all-gather of the logits).
    Both give the same numbers.

    With ``par``, ``logits`` is this rank's shard of the vocabulary over the
    model axis: ``sharded=False`` gathers the whole logits first (the cost
    the reference's mesh shows without ``sharded_ce``); ``sharded=True``
    computes a distributed logsumexp (the max and the sum of exponents
    all-reduced, the gold logit a masked sum all-reduced).  The mean is over
    this rank's tokens (``LM.loss`` takes the mean over the data axes)."""
    if par is not None and par.tp:
        if sharded:
            return _sharded_ce(logits, labels, vocab_size, par)
        logits = par.gather_rep(logits, -1)
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


def _sharded_ce(logits, labels, vocab_size: int, par) -> torch.Tensor:
    v_loc = logits.shape[-1]
    iota = par.m_rank * v_loc + torch.arange(v_loc, device=logits.device)
    valid = iota < vocab_size
    x = torch.where(valid, logits.to(torch.float32), -torch.inf)
    m = par.model_max(torch.amax(x, dim=-1, keepdim=True))
    sumexp = par.reduce(torch.sum(torch.where(valid, torch.exp(x - m), 0.0), dim=-1))
    logz = torch.log(sumexp) + m[..., 0]
    gold = par.reduce(torch.sum(torch.where(iota == labels[..., None], x, 0.0), dim=-1))
    return torch.mean(logz - gold)
