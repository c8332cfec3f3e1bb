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

Under a (data, model) mesh each function takes ``par``
(``models.parallel.Par``) and runs on this rank's heads, as the
reference's ``PartitionSpec``s place them: q, k, v and ``wo`` over the model
axis where it divides the head counts (``wo`` row-parallel, its partial sums
reduced), the whole block replicated where it divides neither.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ShardRules, apply_rope
from repro_torch.models.param import ParamDecl
from repro_torch.models.parallel import MAX

NEG_INF = -1e30


def gqa_decl(cfg: ModelConfig, rules: ShardRules | None = None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rules = rules or ShardRules()
    h_spec, kv_spec = rules.tp(h), rules.tp(kv)
    return {
        "wq": ParamDecl((d, h, hd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "wk": ParamDecl((d, kv, hd), "normal", cfg.dtype, spec=(None, kv_spec, None)),
        "wv": ParamDecl((d, kv, hd), "normal", cfg.dtype, spec=(None, kv_spec, None)),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype, spec=(h_spec, None, None)),
    }


def mla_decl(cfg: ModelConfig, rules: ShardRules | None = None) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    h_spec = (rules or ShardRules()).tp(h)
    return {
        "wq_nope": ParamDecl((d, h, hd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "wq_rope": ParamDecl((d, h, rd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "w_dkv": ParamDecl((d, r), "normal", cfg.dtype, spec=(None, None)),
        "w_krope": ParamDecl((d, rd), "normal", cfg.dtype, spec=(None, None)),
        "w_uk": ParamDecl((r, h, hd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "w_uv": ParamDecl((r, h, hd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype, spec=(h_spec, None, None)),
    }


def cross_attn_decl(cfg: ModelConfig, rules: ShardRules | None = None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rules = rules or ShardRules()
    h_spec, kv_spec = rules.tp(h), rules.tp(kv)
    return {
        "wq": ParamDecl((d, h, hd), "normal", cfg.dtype, spec=(None, h_spec, None)),
        "wk": ParamDecl((cfg.d_image, kv, hd), "normal", cfg.dtype, spec=(None, kv_spec, None)),
        "wv": ParamDecl((cfg.d_image, kv, hd), "normal", cfg.dtype, spec=(None, kv_spec, None)),
        "wo": ParamDecl((h, hd, d), "normal", cfg.dtype, spec=(h_spec, None, None)),
        "gate": ParamDecl((), "zeros", cfg.dtype, spec=()),  # zero-init gated residual
    }


def _placement(cfg: ModelConfig, par) -> tuple[bool, bool]:
    """(q heads sharded, kv heads sharded) over the model axis."""
    hs = par is not None and par.shards(cfg.n_heads)
    return hs, hs and par.shards(cfg.n_kv_heads)


def kv_heads_of(h: int, kv: int, par):
    """The kv heads this rank's q heads read where the model axis shards the
    q heads and not the kv heads: a slice of them (each read by the same
    number of consecutive local q heads, the GQA grouping), or else an
    index, one kv head a local q head."""
    hl, g = h // par.m_size, h // kv
    idx = [(par.m_rank * hl + j) // g for j in range(hl)]
    n = idx[-1] - idx[0] + 1
    if hl % n == 0 and all(idx[j] == idx[0] + j // (hl // n) for j in range(hl)):
        return slice(idx[0], idx[0] + n)
    return torch.tensor(idx)


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
                return_kv: bool = False, par=None):
    """Training/prefill path. x: (b, s, d) on the residual's layout. With
    return_kv, also returns the roped (k, v) so prefill can hand the cache
    to decode (this rank's kv heads where the model axis shards them).

    With ``par``: this rank's h / M q heads and kv / M kv heads go to K11 and
    K11b as they are, and ``wo`` is row-parallel (partial sums reduced over
    the model axis).  Where M divides the q heads but not the kv heads, k
    and v are computed whole and each local q head reads its own kv head;
    where M divides neither, the block is replicated and issues no
    collective."""
    hs, kvs = _placement(cfg, par)
    if par is not None:
        x = par.enter(x, sharded=kvs)
    xq = par.copy(x) if hs and not kvs else x
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kk, vv = k, v
    if hs and not kvs:
        sel = kv_heads_of(cfg.n_heads, cfg.n_kv_heads, par)
        kk, vv = par.copy(k)[:, :, sel], par.copy(v)[:, :, sel]
    w = cfg.attn_window if window is None else window
    o = flash_attention(q, kk, vv, causal=True, window=w, unroll=cfg.unroll_scan,
                        skip_masked=cfg.causal_skip)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    if par is not None:
        out = par.leave(out, partial=hs)
    if return_kv:
        return out, (k, v)
    return out


def _cache_window(cache: torch.Tensor, par) -> tuple[int, int, bool]:
    """(global slots S, this rank's first slot, sequence over data): where
    the batch does not lie over the data axes, the cache's sequence does."""
    s_loc = cache.shape[1]
    if par is None or par.batch or par.d_size == 1:
        return s_loc, 0, False
    return s_loc * par.d_size, par.d_rank * s_loc, True


def _attend(sc: torch.Tensor, values: torch.Tensor, eq: str, par, over_data: bool):
    """softmax(sc) . values (``eq``'s product): over data, a distributed
    softmax (the max and the sum of exponents all-reduced over the data
    axes, then the rank's share of the product)."""
    if not over_data:
        p = torch.softmax(sc, dim=-1).to(values.dtype)
        return torch.einsum(eq, p, values)
    m = par.data_reduce(torch.amax(sc, dim=-1, keepdim=True), MAX)
    e = torch.exp(sc - m)
    p = (e / par.data_reduce(torch.sum(e, dim=-1, keepdim=True))).to(values.dtype)
    return par.data_reduce(torch.einsum(eq, p, values))


def gqa_decode(params, x, cache_k, cache_v, pos: int, cfg: ModelConfig, *,
               window: int | None = None, par=None):
    """Single-token decode. x: (b, 1, d); cache: (b, S, kv, hd); pos: int.

    With a sliding window the cache is a ring buffer of size S = window.  The
    new token's K and V are written into the cache in place (the reference's
    ``dynamic_update_slice`` returns a new cache; here that would copy every
    layer's cache every step).  Returns (out (b, 1, d), cache_k, cache_v).

    With ``par`` the cache is placed as ``launch.specs.cache_pspecs`` says:
    kv heads over the model axis where M divides them (else whole, each
    local q head reading its kv head), and, for a batch the data axes do not
    divide, the sequence over the data axes: each rank scores its slots, the
    softmax is combined across data ranks, and slot ``pos % S`` is written
    by the rank that holds it."""
    hs, kvs = _placement(cfg, par)
    b = x.shape[0]
    s_cache, lo, over_data = _cache_window(cache_k, par)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    at = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    slot = pos % s_cache  # ring buffer when s_cache == window
    if lo <= slot < lo + cache_k.shape[1]:
        cache_k[:, slot - lo] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - lo] = v[:, 0].to(cache_v.dtype)
    ck, cv = cache_k, cache_v
    if hs and not kvs:
        sel = kv_heads_of(cfg.n_heads, cfg.n_kv_heads, par)
        ck, cv = ck[:, :, sel], cv[:, :, sel]
    kv = ck.shape[2]
    g = q.shape[2] // kv
    qg = q.reshape(b, 1, kv, g, q.shape[-1])
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(torch.float32), ck.to(torch.float32))
    sc = sc / math.sqrt(q.shape[-1])  # sqrt rounds correctly in fp32 and fp64 alike
    # valid cache slots: those already written. Once the ring buffer wraps
    # (pos >= s_cache) every slot holds one of the last s_cache tokens.
    idx = lo + torch.arange(ck.shape[1], device=x.device)
    valid = (idx <= pos) | (pos >= s_cache)
    sc = torch.where(valid[None, None, None, None, :], sc, torch.full_like(sc, NEG_INF))
    o = _attend(sc, cv, "bqkgs,bskd->bqkgd", par, over_data)
    o = o.reshape(b, 1, q.shape[2], q.shape[-1])
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return (par.reduce(out) if hs else out), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed kv cache + decoupled rope, absorbed decode
# ---------------------------------------------------------------------------


def mla_forward(params, x, positions, cfg: ModelConfig, *, return_cache: bool = False,
                par=None):
    """Training/prefill path. x: (b, s, d).  K11 runs at d = hd + rope_head_dim
    and dv = hd, its scale 1/sqrt(d) as the reference's scan's.  With
    return_cache, also returns the cache columns (c (b, s, r), kr (b, s, rd)).
    With ``par``: ``w_dkv`` and ``w_krope`` replicated, the per-head
    weights and ``wo`` over this rank's heads (``wo`` row-parallel)."""
    hs = par is not None and par.shards(cfg.n_heads)
    if par is not None:
        x = par.enter(x, sharded=False)
    xq = par.copy(x) if hs else x
    q_nope = torch.einsum("bsd,dhk->bshk", xq, params["wq_nope"])
    q_rope = torch.einsum("bsd,dhk->bshk", xq, params["wq_rope"])
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ params["w_dkv"]  # (b, s, r)
    k_rope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                        cfg.rope_theta)  # (b, s, 1, rd)
    c_used, kr_used = (par.copy(c_kv), par.copy(k_rope)) if hs else (c_kv, k_rope)
    k_nope = torch.einsum("bsr,rhk->bshk", c_used, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_used, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr_used.expand(*k_nope.shape[:3], kr_used.shape[-1])], dim=-1)
    o = flash_attention(q, k, v, causal=True, unroll=cfg.unroll_scan,
                        skip_masked=cfg.causal_skip)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    if par is not None:
        out = par.leave(out, partial=hs)
    if return_cache:
        return out, (c_kv, k_rope[:, :, 0, :])
    return out


def mla_decode(params, x, cache_c, cache_kr, pos: int, cfg: ModelConfig, *, par=None):
    """Absorbed decode: scores live in the r-dim latent space, so a token's
    cache is r + rope_head_dim numbers.  x: (b, 1, d); cache_c: (b, S, r);
    cache_kr: (b, S, rd); the new token's columns are written at ``pos`` in
    place (the reference returns new caches), or, past the cache's end, at
    its last slot: the reference's ``dynamic_update_slice`` clamps its start
    index so (a windowed config, such as the dry run's long_500k, runs the
    MLA cache that way).  Returns (out (b, 1, d), cache_c, cache_kr).  With
    ``par``: this rank's heads, the latent cache replicated over the model
    axis, its sequence over the data axes as in :func:`gqa_decode`."""
    hs = par is not None and par.shards(cfg.n_heads)
    s_cache, lo, over_data = _cache_window(cache_c, par)
    q_nope = torch.einsum("bsd,dhk->bshk", x, params["wq_nope"])
    q_rope = torch.einsum("bsd,dhk->bshk", x, params["wq_rope"])
    at = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q_rope, at, cfg.rope_theta)
    c_new = x @ params["w_dkv"]  # (b, 1, r)
    kr_new = apply_rope((x @ params["w_krope"])[:, :, None, :], at, cfg.rope_theta)[:, :, 0, :]
    slot = min(pos, s_cache - 1)
    if lo <= slot < lo + cache_c.shape[1]:
        cache_c[:, slot - lo] = c_new[:, 0].to(cache_c.dtype)
        cache_kr[:, slot - lo] = kr_new[:, 0].to(cache_kr.dtype)
    # absorb W_uk into q: (b, 1, h, hd) x (r, h, hd) -> (b, 1, h, r)
    q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, params["w_uk"])
    f32 = torch.float32
    sc = torch.einsum("bqhr,bsr->bqhs", q_eff.to(f32), cache_c.to(f32))
    sc = sc + torch.einsum("bqhk,bsk->bqhs", q_rope.to(f32), cache_kr.to(f32))
    sc = sc / math.sqrt(cfg.hd + cfg.rope_head_dim)
    valid = lo + torch.arange(cache_c.shape[1], device=x.device) <= pos
    sc = torch.where(valid[None, None, None, :], sc, torch.full_like(sc, NEG_INF))
    ctx = _attend(sc, cache_c, "bqhs,bsr->bqhr", par, over_data)  # (b, 1, h, r)
    o = torch.einsum("bqhr,rhk->bqhk", ctx, params["w_uv"])
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return (par.reduce(out) if hs else out), cache_c, cache_kr


# ---------------------------------------------------------------------------
# cross-attention (VLM): text queries attend to image embeddings
# ---------------------------------------------------------------------------


def cross_attn_forward(params, x, img_kv: tuple[torch.Tensor, torch.Tensor], cfg: ModelConfig,
                       *, par=None):
    """x: (b, s, d); img_kv: the projected (k, v), each (b, n_img, kv, hd)
    (this rank's kv heads where the model axis shards them).  No mask:
    every query sees every image token.  With ``par``, GQA's placements."""
    k, v = img_kv
    hs, kvs = _placement(cfg, par)
    if par is not None:
        x = par.enter(x, sharded=kvs)
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", par.copy(x) if hs and not kvs else x, params["wq"])
    if hs and not kvs:
        sel = kv_heads_of(cfg.n_heads, cfg.n_kv_heads, par)
        k, v = par.copy(k)[:, :, sel], par.copy(v)[:, :, sel]
    kvh, hd = k.shape[2], q.shape[-1]
    g = q.shape[2] // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(torch.float32), k.to(torch.float32))
    sc = sc / math.sqrt(hd)
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v).reshape(b, s, q.shape[2], hd)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    gate = params["gate"]
    if par is not None:
        out, gate = par.leave(out, partial=hs), par.norm_scale(gate)
    return torch.tanh(gate).to(x.dtype) * out


def image_kv(params, img_emb: torch.Tensor):
    """Project image embeddings once: (b, n_img, d_image) -> (k, v)."""
    k = torch.einsum("bsd,dhk->bshk", img_emb, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", img_emb, params["wv"])
    return k, v
