"""Decoder block bodies: decls + apply for the dense and MoE families, with
GQA or MLA attention.

Port of ``repro.models.blocks`` for decoder blocks.  ``model.py`` keeps the
reference's stacked layer axis and loops over it in Python.  SSM and
cross-attention blocks wait for later steps (ROADMAP queue 1, steps 13e and
13g) and raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp, mlp_decl, rmsnorm, rmsnorm_decl

_LATER = {
    "ssm": "SSM (Mamba2) blocks: ROADMAP queue 1, step 13e",
    "cross": "cross-attention (VLM) blocks: ROADMAP queue 1, step 13g",
}


def decoder_block_decl(cfg: ModelConfig) -> dict:
    d = {
        "ln_attn": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "ln_mlp": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "attn": attn.mla_decl(cfg) if cfg.kv_lora_rank else attn.gqa_decl(cfg),
    }
    if cfg.n_experts:
        d["moe"] = moe_mod.moe_decl(cfg)
    else:
        d["mlp"] = mlp_decl(cfg)
    return d


def decoder_block_forward(params, x, positions, cfg: ModelConfig, *, window: int | None = None,
                          collect_cache: bool = False):
    """Returns (x, aux_loss) — or (x, aux_loss, cache_entry) when collecting."""
    h = rmsnorm(params["ln_attn"], x, cfg.norm_eps)
    cache = None
    if cfg.kv_lora_rank:
        if collect_cache:
            o, (c, kr) = attn.mla_forward(params["attn"], h, positions, cfg, return_cache=True)
            cache = {"c": c, "kr": kr}
        else:
            o = attn.mla_forward(params["attn"], h, positions, cfg)
    elif collect_cache:
        o, (k, v) = attn.gqa_forward(params["attn"], h, positions, cfg, window=window,
                                     return_kv=True)
        cache = {"k": k, "v": v}
    else:
        o = attn.gqa_forward(params["attn"], h, positions, cfg, window=window)
    x = x + o
    h = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_mod.moe_forward(params["moe"], h, cfg)
        x = x + y
    else:
        x, aux = x + mlp(params["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        return x, aux, cache
    return x, aux


def decoder_block_decode(params, x, cache, pos: int, cfg: ModelConfig, *,
                         window: int | None = None):
    """cache: dict of per-layer tensors, updated in place. Returns (x, cache)."""
    h = rmsnorm(params["ln_attn"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        o, c, kr = attn.mla_decode(params["attn"], h, cache["c"], cache["kr"], pos, cfg)
        cache = {"c": c, "kr": kr}
    else:
        o, ck, cv = attn.gqa_decode(params["attn"], h, cache["k"], cache["v"], pos, cfg,
                                    window=window)
        cache = {"k": ck, "v": cv}
    x = x + o
    h = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, _ = moe_mod.moe_forward(params["moe"], h, cfg)
        return x + y, cache
    return x + mlp(params["mlp"], h), cache


def decoder_cache_decl(cfg: ModelConfig, batch: int, s_cache: int) -> dict:
    """Per-layer cache shapes (dtype = cfg.dtype)."""
    if cfg.kv_lora_rank:
        return {
            "c": (batch, s_cache, cfg.kv_lora_rank),
            "kr": (batch, s_cache, cfg.rope_head_dim),
        }
    return {
        "k": (batch, s_cache, cfg.n_kv_heads, cfg.hd),
        "v": (batch, s_cache, cfg.n_kv_heads, cfg.hd),
    }


def ssm_block_decl(cfg: ModelConfig) -> dict:
    raise NotImplementedError(_LATER["ssm"])


def cross_block_decl(cfg: ModelConfig) -> dict:
    raise NotImplementedError(_LATER["cross"])
