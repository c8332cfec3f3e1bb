"""Attention: GQA with blockwise online softmax (K11) and sliding window,
DeepSeek MLA, and cross-attention.

Port of ``repro.models.attention``.  Training and
prefill attention is :func:`flash_attention`: on CUDA tensors the
hand-written K11 kernel (``kernels/csrc/flash_attention.cu``; bf16 on the
tensor cores, any head widths), the reference kernel's math, which the
reference's jnp blockwise scan (its ``models/attention.py:81``) also
computes; on CPU tensors the dense plain version.  Its gradient is K11b
(``kernels/csrc/flash_attention_bwd.cu``) through the autograd Function
``kernels.flash_attention.FlashAttention``, where the reference
differentiates its scan.  One difference is kept on
purpose: the scan rounds the softmax weights p to v's dtype before the PV
product, K11 keeps them to fp32 precision (in bf16, as three bf16 parts whose
sum is p), so in bf16 the port differs from the reference's model by that
rounding.  Decode is a single-token product against the KV cache, as in the
reference.

MLA (DeepSeek-V2) keeps a compressed cache: the latent ``c`` (r wide) and
one roped key column ``kr`` a token, shared by the heads.  Its prefill
expands them into per-head keys [k_nope; k_rope] and values and runs K11 at
d = hd + rope_head_dim, dv = hd; its decode absorbs W_uk into the query and
scores against the latent cache directly.

Cross-attention (VLM): text queries attend to the image tokens' keys and
values, projected once a prompt (:func:`image_kv`).  The reference computes
it in jnp outside its Pallas kernel, so the port computes it in plain torch,
with the scores in fp32, p cast to v's dtype before the PV product, and the
block's tanh gate (zero at init) on the output.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import ParamDecl

NEG_INF = -1e30


def gqa_decl(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDecl((d, h, hd), "normal", cfg.dtype),
        "wk": ParamDecl((d, kv, hd), "normal", cfg.dtype),
        "wv": ParamDecl((d, kv, hd), "normal", cfg.dtype),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype),
    }


def mla_decl(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "wq_nope": ParamDecl((d, h, hd), "normal", cfg.dtype),
        "wq_rope": ParamDecl((d, h, rd), "normal", cfg.dtype),
        "w_dkv": ParamDecl((d, r), "normal", cfg.dtype),
        "w_krope": ParamDecl((d, rd), "normal", cfg.dtype),
        "w_uk": ParamDecl((r, h, hd), "normal", cfg.dtype),
        "w_uv": ParamDecl((r, h, hd), "normal", cfg.dtype),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype),
    }


def cross_attn_decl(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDecl((d, h, hd), "normal", cfg.dtype),
        "wk": ParamDecl((cfg.d_image, kv, hd), "normal", cfg.dtype),
        "wv": ParamDecl((cfg.d_image, kv, hd), "normal", cfg.dtype),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype),
        "gate": ParamDecl((), "zeros", cfg.dtype),  # zero-init gated residual
    }


def flash_attention(
    q: torch.Tensor,  # (b, s, h, hd)
    k: torch.Tensor,  # (b, s, kv, hd)
    v: torch.Tensor,  # (b, s, kv, vd)
    *,
    causal: bool = True,
    window: int = 0,  # sliding window (0 = unlimited)
    unroll: bool = False,  # accepted: an XLA scheduling switch
    skip_masked: bool = False,  # accepted: K11 always skips tiles outside the band
) -> torch.Tensor:
    """(b, s, h, hd) x (b, s, kv, hd) x (b, s, kv, vd) -> (b, s, h, vd).

    The heads-first views go to K11 without a copy (it reads strides), and
    its output comes back in (b, s, h, vd) memory order."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    return o.transpose(1, 2)


def gqa_forward(params, x, positions, cfg: ModelConfig, *, window: int | None = None,
                return_kv: bool = False):
    """Training/prefill path. x: (b, s, d). With return_kv, also returns the
    roped (k, v) so prefill can hand the cache to decode."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    w = cfg.attn_window if window is None else window
    o = flash_attention(q, k, v, causal=True, window=w, unroll=cfg.unroll_scan,
                        skip_masked=cfg.causal_skip)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(params, x, cache_k, cache_v, pos: int, cfg: ModelConfig, *,
               window: int | None = None):
    """Single-token decode. x: (b, 1, d); cache: (b, S, kv, hd); pos: int.

    With a sliding window the cache is a ring buffer of size S = window.  The
    new token's K and V are written into the cache in place (the reference's
    ``dynamic_update_slice`` returns a new cache; here that would copy every
    layer's cache every step).  Returns (out (b, 1, d), cache_k, cache_v)."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    at = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    slot = pos % s_cache  # ring buffer when s_cache == window
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    kv = cache_k.shape[2]
    g = q.shape[2] // kv
    qg = q.reshape(b, 1, kv, g, q.shape[-1])
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(torch.float32), cache_k.to(torch.float32))
    sc = sc / math.sqrt(q.shape[-1])  # sqrt rounds correctly in fp32 and fp64 alike
    # valid cache slots: those already written. Once the ring buffer wraps
    # (pos >= s_cache) every slot holds one of the last s_cache tokens.
    idx = torch.arange(s_cache, device=x.device)
    valid = (idx <= pos) | (pos >= s_cache)
    sc = torch.where(valid[None, None, None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, cache_v).reshape(b, 1, q.shape[2], q.shape[-1])
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed kv cache + decoupled rope, absorbed decode
# ---------------------------------------------------------------------------


def mla_forward(params, x, positions, cfg: ModelConfig, *, return_cache: bool = False):
    """Training/prefill path. x: (b, s, d).  K11 runs at d = hd + rope_head_dim
    and dv = hd, its scale 1/sqrt(d) as the reference's scan's.  With
    return_cache, also returns the cache columns (c (b, s, r), kr (b, s, rd))."""
    q_nope = torch.einsum("bsd,dhk->bshk", x, params["wq_nope"])
    q_rope = torch.einsum("bsd,dhk->bshk", x, params["wq_rope"])
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ params["w_dkv"]  # (b, s, r)
    k_rope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                        cfg.rope_theta)  # (b, s, 1, rd)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
    o = flash_attention(q, k, v, causal=True, unroll=cfg.unroll_scan,
                        skip_masked=cfg.causal_skip)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    if return_cache:
        return out, (c_kv, k_rope[:, :, 0, :])
    return out


def mla_decode(params, x, cache_c, cache_kr, pos: int, cfg: ModelConfig):
    """Absorbed decode: scores live in the r-dim latent space, so a token's
    cache is r + rope_head_dim numbers.  x: (b, 1, d); cache_c: (b, S, r);
    cache_kr: (b, S, rd); the new token's columns are written at ``pos`` in
    place (the reference returns new caches), or, past the cache's end, at
    its last slot: the reference's ``dynamic_update_slice`` clamps its start
    index so (a windowed config, such as the dry run's long_500k, runs the
    MLA cache that way).  Returns (out (b, 1, d), cache_c, cache_kr)."""
    q_nope = torch.einsum("bsd,dhk->bshk", x, params["wq_nope"])
    q_rope = torch.einsum("bsd,dhk->bshk", x, params["wq_rope"])
    at = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q_rope, at, cfg.rope_theta)
    c_new = x @ params["w_dkv"]  # (b, 1, r)
    kr_new = apply_rope((x @ params["w_krope"])[:, :, None, :], at, cfg.rope_theta)[:, :, 0, :]
    slot = min(pos, cache_c.shape[1] - 1)
    cache_c[:, slot] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[:, slot] = kr_new[:, 0].to(cache_kr.dtype)
    # absorb W_uk into q: (b, 1, h, hd) x (r, h, hd) -> (b, 1, h, r)
    q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, params["w_uk"])
    f32 = torch.float32
    sc = torch.einsum("bqhr,bsr->bqhs", q_eff.to(f32), cache_c.to(f32))
    sc = sc + torch.einsum("bqhk,bsk->bqhs", q_rope.to(f32), cache_kr.to(f32))
    sc = sc / math.sqrt(cfg.hd + cfg.rope_head_dim)
    valid = torch.arange(cache_c.shape[1], device=x.device) <= pos
    sc = torch.where(valid[None, None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1).to(cache_c.dtype)
    ctx = torch.einsum("bqhs,bsr->bqhr", p, cache_c)  # (b, 1, h, r)
    o = torch.einsum("bqhr,rhk->bqhk", ctx, params["w_uv"])
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache_c, cache_kr


# ---------------------------------------------------------------------------
# cross-attention (VLM): text queries attend to image embeddings
# ---------------------------------------------------------------------------


def cross_attn_forward(params, x, img_kv: tuple[torch.Tensor, torch.Tensor], cfg: ModelConfig):
    """x: (b, s, d); img_kv: the projected (k, v), each (b, n_img, kv, hd).
    No mask: every query sees every image token."""
    k, v = img_kv
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    kvh, hd = k.shape[2], q.shape[-1]
    g = q.shape[2] // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(torch.float32), k.to(torch.float32))
    sc = sc / math.sqrt(hd)
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v).reshape(b, s, q.shape[2], hd)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return torch.tanh(params["gate"]).to(x.dtype) * out


def image_kv(params, img_emb: torch.Tensor):
    """Project image embeddings once: (b, n_img, d_image) -> (k, v)."""
    k = torch.einsum("bsd,dhk->bshk", img_emb, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", img_emb, params["wv"])
    return k, v
