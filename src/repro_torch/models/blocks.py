"""Block bodies: decls + apply for every family: decoder blocks (dense and
MoE, GQA or MLA attention), Mamba2 (SSM) blocks and the VLM's
cross-attention blocks.

Port of ``repro.models.blocks``.  ``model.py`` keeps the reference's stacked
layer axis and loops over it in Python, slicing the grouped stacks of the
hybrid (shared attention) and VLM (cross-attention) families.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_decl, rmsnorm, rmsnorm_decl


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
                          collect_cache: bool = False, rules=None):
    """Returns (x, aux_loss) — or (x, aux_loss, cache_entry) when collecting.
    With ``cfg.moe_ep`` and ``rules`` holding a mesh, the MoE is the
    expert-parallel ``moe_forward_ep``."""
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
        if cfg.moe_ep and rules is not None and getattr(rules, "mesh", None) is not None:
            y, aux = moe_mod.moe_forward_ep(params["moe"], h, cfg, rules)
        else:
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


# ---------------------------------------------------------------------------
# ssm (mamba2) blocks
# ---------------------------------------------------------------------------


def ssm_block_decl(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_decl(cfg.d_model, cfg.dtype), "ssm": ssm_mod.ssm_decl(cfg)}


def ssm_block_forward(params, x, cfg: ModelConfig, *, collect_cache: bool = False):
    """Returns (x, aux_loss = 0) — or (x, aux_loss, {"ssm", "conv"}) when collecting."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        y, cache = ssm_mod.ssm_forward(params["ssm"], h, cfg, return_state=True)
        return x + y, zero, cache
    return x + ssm_mod.ssm_forward(params["ssm"], h, cfg), zero


def ssm_block_decode(params, x, cache, cfg: ModelConfig):
    """cache: {"ssm", "conv"}, updated in place. Returns (x, cache)."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    y, cache = ssm_mod.ssm_decode(params["ssm"], h, cache, cfg)
    return x + y, cache


def ssm_cache_decl(cfg: ModelConfig, batch: int) -> dict:
    """Per-layer cache shapes ("ssm" in fp32, "conv" in cfg.dtype)."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": (batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv_width - 1, ch),
    }


# ---------------------------------------------------------------------------
# cross-attention block (VLM)
# ---------------------------------------------------------------------------


def cross_block_decl(cfg: ModelConfig) -> dict:
    return {
        "ln_x": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "ln_mlp": rmsnorm_decl(cfg.d_model, cfg.dtype),
        "xattn": attn.cross_attn_decl(cfg),
        "mlp": mlp_decl(cfg),
    }


def cross_block_forward(params, x, img_kv, cfg: ModelConfig):
    h = rmsnorm(params["ln_x"], x, cfg.norm_eps)
    x = x + attn.cross_attn_forward(params["xattn"], h, img_kv, cfg)
    h = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h)
