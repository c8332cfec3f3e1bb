"""Decoder block bodies: decls + apply for the dense GQA family.

Port of ``repro.models.blocks`` for dense decoder blocks.  ``model.py`` keeps
the reference's stacked layer axis and loops over it in Python.  MoE, MLA,
SSM and cross-attention blocks wait for later steps (ROADMAP queue 1,
steps 13c-13g) and raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_decl, rmsnorm, rmsnorm_decl

_LATER = {
    "moe": "MoE blocks: ROADMAP queue 1, step 13c",
    "mla": "MLA attention: ROADMAP queue 1, step 13d",
    "ssm": "SSM (Mamba2) blocks: ROADMAP queue 1, step 13e",
    "cross": "cross-attention (VLM) blocks: ROADMAP queue 1, step 13g",
}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(_LATER["moe"])
    if cfg.kv_lora_rank:
        raise NotImplementedError(_LATER["mla"])


def decoder_block_decl(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    return {
        "ln_attn": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "ln_mlp": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "attn": attn.gqa_decl(cfg),
        "mlp": mlp_decl(cfg),
    }


def decoder_block_forward(params, x, positions, cfg: ModelConfig, *, window: int | None = None,
                          collect_cache: bool = False):
    """Returns (x, aux_loss) — or (x, aux_loss, cache_entry) when collecting."""
    _dense_only(cfg)
    h = rmsnorm(params["ln_attn"], x, cfg.norm_eps)
    cache = None
    if collect_cache:
        o, (k, v) = attn.gqa_forward(params["attn"], h, positions, cfg, window=window,
                                     return_kv=True)
        cache = {"k": k, "v": v}
    else:
        o = attn.gqa_forward(params["attn"], h, positions, cfg, window=window)
    x = x + o
    h = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    x, aux = x + mlp(params["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        return x, aux, cache
    return x, aux


def decoder_block_decode(params, x, cache, pos: int, cfg: ModelConfig, *,
                         window: int | None = None):
    """cache: dict of per-layer tensors, updated in place. Returns (x, cache)."""
    _dense_only(cfg)
    h = rmsnorm(params["ln_attn"], x, cfg.norm_eps)
    o, ck, cv = attn.gqa_decode(params["attn"], h, cache["k"], cache["v"], pos, cfg,
                                window=window)
    x = x + o
    h = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h), {"k": ck, "v": cv}


def decoder_cache_decl(cfg: ModelConfig, batch: int, s_cache: int) -> dict:
    """Per-layer cache shapes (dtype = cfg.dtype)."""
    _dense_only(cfg)
    return {
        "k": (batch, s_cache, cfg.n_kv_heads, cfg.hd),
        "v": (batch, s_cache, cfg.n_kv_heads, cfg.hd),
    }


def ssm_block_decl(cfg: ModelConfig) -> dict:
    raise NotImplementedError(_LATER["ssm"])


def cross_block_decl(cfg: ModelConfig) -> dict:
    raise NotImplementedError(_LATER["cross"])
