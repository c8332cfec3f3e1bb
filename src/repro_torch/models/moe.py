"""Mixture-of-Experts with top-k routing and capacity-bounded dispatch.

Port of ``repro.models.moe``.  Each (token, choice) pair takes a slot of its
expert's buffer (E, C, d) in token-major order, pairs past the capacity C
are dropped, one batched product per weight runs every expert over its
buffer, and each token adds its chosen experts' rows weighted by the
renormalised router probabilities.  No (T, E, C) dispatch tensor is formed.
DeepSeek-style shared experts (always-on dense MLPs) add to the routed
output, and the Switch load-balance loss comes back as the aux term.

The steps keep the reference's arithmetic: fp32 router logits and softmax;
the top k by a stable descending sort, which orders ties by the lower expert
index as ``jax.lax.top_k`` does (``torch.topk`` promises no tie order); the
expert products in the config dtype; the k weighted rows of a token added
in choice order into a zero of the config dtype, rounding after each add, as
the reference's scatter-add does (``index_add_`` would add with atomics on
the card, in an order and with a rounding that change from run to run).

``moe_forward_ep``, the reference's expert-parallel dispatch over a device
mesh, waits for the port's mesh (ROADMAP queue 1, step 13i).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp, mlp_decl
from repro_torch.models.param import ParamDecl


def moe_decl(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    decl = {
        "router": ParamDecl((d, e), "normal", torch.float32),
        "gate": ParamDecl((e, d, f), "normal", cfg.dtype),
        "up": ParamDecl((e, d, f), "normal", cfg.dtype),
        "down": ParamDecl((e, f, d), "normal", cfg.dtype),
    }
    if cfg.n_shared_experts:
        decl["shared"] = mlp_decl(cfg, d_ff=cfg.n_shared_experts * cfg.d_ff)
    return decl


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def route(params, xt: torch.Tensor, cfg: ModelConfig):
    """Router of tokens ``xt`` (T, d): (probs (T, E), top_p (T, k) renormalised,
    top_e (T, k)), the top k by probability, ties to the lower expert."""
    logits = xt.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, e: int, c: int):
    """Slots of the flattened (token, choice) pairs, token-major: (slot (T k,),
    keep (T k,)); pair j takes slot ``e_j c + pos_j``, pos_j the count of
    earlier pairs routed to its expert, and the overflow slot ``e c`` where
    pos_j reaches the capacity c."""
    flat_e = top_e.reshape(-1)
    # (E, T k), so the count runs along rows: a scan over the outer dimension
    # of a (T k, E) tensor takes one thread a column on the card
    one_hot = F.one_hot(flat_e, e).to(torch.int32).T.contiguous()
    pos = torch.cumsum(one_hot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 0, flat_e[None, :])[0]
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, torch.full_like(flat_e, e * c))
    return slot, keep


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (b, s, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)

    probs, top_p, top_e = route(params, xt, cfg)
    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    flat_e = top_e.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (t * k)  # counts: exact
    aux = e * torch.sum(me * ce)

    c = capacity(cfg, t)
    slot, keep = dispatch(top_e, e, c)
    # each kept pair owns its slot, so the reference's scatter-add into zeros
    # is a write; the dropped pairs all land on the overflow row, cut below
    buf = torch.zeros((e * c + 1, d), dtype=cfg.dtype, device=x.device)
    buf[slot] = xt.repeat_interleave(k, dim=0).to(cfg.dtype)
    buf = buf[:-1].reshape(e, c, d)

    h = F.silu(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    out = torch.bmm(h, params["down"]).reshape(e * c, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype, device=out.device)])  # overflow

    weight = (top_p.reshape(-1) * keep).to(out.dtype)
    gathered = (out[slot] * weight[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=cfg.dtype, device=x.device)
    for j in range(k):  # choice order, one rounding an add
        y = y + gathered[:, j]

    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xt)
    return y.reshape(b, s, d), aux


def moe_forward_ep(params, x: torch.Tensor, cfg: ModelConfig, rules=None):
    """The reference's expert-parallel dispatch (``shard_map`` over a mesh's
    model axis) needs the port's mesh and ``ShardRules``."""
    raise NotImplementedError("expert-parallel MoE needs launch/mesh.py: ROADMAP queue 1, "
                              "step 13i")
