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

``moe_forward_ep`` is the reference's expert-parallel dispatch over a
``torch.distributed`` mesh (``launch.mesh``): each (data, model) rank routes
its own tokens to its own E / M experts, with the same steps and a capacity
from its own token count, and one all-reduce over the model axis combines
the experts' outputs.
"""
from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ShardRules, mlp, mlp_decl
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


def _positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each flattened pair's count of earlier pairs routed to its expert."""
    # (E, T k), so the count runs along rows: a scan over the outer dimension
    # of a (T k, E) tensor takes one thread a column on the card
    one_hot = F.one_hot(flat_e, e).to(torch.int32).T.contiguous()
    pos = torch.cumsum(one_hot, dim=1, dtype=torch.int32) - 1
    return torch.gather(pos, 0, flat_e[None, :])[0]


def dispatch(top_e: torch.Tensor, e: int, c: int):
    """Slots of the flattened (token, choice) pairs, token-major: (slot (T k,),
    keep (T k,)); pair j takes slot ``e_j c + pos_j``, pos_j the count of
    earlier pairs routed to its expert, and the overflow slot ``e c`` where
    pos_j reaches the capacity c."""
    flat_e = top_e.reshape(-1)
    pos = _positions(flat_e, e)
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, torch.full_like(flat_e, e * c))
    return slot, keep


def _aux(probs: torch.Tensor, top_e: torch.Tensor, e: int) -> torch.Tensor:
    """Switch load-balance loss: E * sum_e f_e * p_e."""
    me = torch.mean(probs, dim=0)
    flat_e = top_e.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / flat_e.numel()  # exact
    return e * torch.sum(me * ce)


def _experts(xt, top_p, slot, keep, c: int, gate, up, down, cfg: ModelConfig) -> torch.Tensor:
    """The kept pairs through the buffers of the experts ``gate``, ``up``,
    ``down`` ((E', ...) stacks; pair j in slot ``slot_j``, capacity c, the
    overflow slot E' c) and each token's k weighted rows added in choice
    order: (T, d) in the config dtype."""
    t, d = xt.shape
    e, k = gate.shape[0], top_p.shape[1]
    # each kept pair owns its slot, so the reference's scatter-add into zeros
    # is a write; the dropped pairs all land on the overflow row, cut below
    buf = torch.zeros((e * c + 1, d), dtype=cfg.dtype, device=xt.device)
    buf[slot] = xt.repeat_interleave(k, dim=0).to(cfg.dtype)
    buf = buf[:-1].reshape(e, c, d)

    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    out = torch.bmm(h, down).reshape(e * c, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype, device=out.device)])  # overflow

    weight = (top_p.reshape(-1) * keep).to(out.dtype)
    gathered = (out[slot] * weight[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=cfg.dtype, device=xt.device)
    for j in range(k):  # choice order, one rounding an add
        y = y + gathered[:, j]
    return y


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (b, s, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, top_p, top_e = route(params, xt, cfg)
    aux = _aux(probs, top_e, cfg.n_experts)
    c = capacity(cfg, t)
    slot, keep = dispatch(top_e, cfg.n_experts, c)
    y = _experts(xt, top_p, slot, keep, c, params["gate"], params["up"], params["down"], cfg)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xt)
    return y.reshape(b, s, d), aux


def moe_forward_ep(params, x: torch.Tensor, cfg: ModelConfig, rules: ShardRules):
    """Expert-parallel MoE over ``rules.mesh`` (a ``DeviceMesh`` with the
    axes ``rules.batch_axes`` and ``rules.model_axis``).  ``x`` is this
    rank's (b_loc, s, d) tokens: the batch split over the data axes, the same
    on every rank of a model group.  The expert weights are the whole (E,
    ...) stacks, of which this rank takes its E / M experts, or this rank's
    (E / M, ...) shard.  Returns this rank's (y (b_loc, s, d), aux).

    The reference's ``shard_map`` body (``repro.models.moe``): every rank
    routes its T = b_loc s tokens over all E experts, with the capacity of T
    tokens; a pair is kept where its position is under the capacity and its
    expert is this rank's; each token adds its kept rows in choice order
    (the others add zero); one all-reduce over the model axis sums the
    ranks' outputs, then the shared experts are added.  The load-balance
    loss is averaged over the data axes (x is the same across the model
    axis).  The all-reduces are ``torch.distributed.nn``'s, which autograd
    differentiates, as ``jax.grad`` does the reference's ``psum``.  At a mesh
    of one rank this is :func:`moe_forward` bit for bit, and a mesh axis of
    size 1 issues no collective."""
    mesh = rules.mesh
    names = list(mesh.mesh_dim_names)

    def size(axis):
        return int(mesh.size(names.index(axis)))

    b, s, d = x.shape
    t = b * s
    e_total, m_axis = cfg.n_experts, rules.model_axis
    m_size = size(m_axis)
    e_loc = e_total // m_size
    m_idx = mesh.get_local_rank(m_axis) if m_size > 1 else 0
    xt = x.reshape(t, d)

    probs, top_p, top_e = route(params, xt, cfg)
    aux = _aux(probs, top_e, e_total)
    for axis in rules.batch_axes:  # the mean over the data axes
        if size(axis) > 1:
            aux = dist_fn.all_reduce(aux, group=mesh.get_group(axis)) / size(axis)

    c = capacity(cfg, t)
    flat_e = top_e.reshape(-1)
    pos = _positions(flat_e, e_total)
    local_e = flat_e - m_idx * e_loc
    keep = (pos < c) & (local_e >= 0) & (local_e < e_loc)
    slot = torch.where(keep, local_e * c + pos, torch.full_like(flat_e, e_loc * c))

    def local(w):
        return w if w.shape[0] == e_loc else w[m_idx * e_loc:(m_idx + 1) * e_loc]

    y = _experts(xt, top_p, slot, keep, c, local(params["gate"]), local(params["up"]),
                 local(params["down"]), cfg)
    if m_size > 1:  # combine the contributions of every expert shard
        y = dist_fn.all_reduce(y, group=mesh.get_group(m_axis))
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xt)
    return y.reshape(b, s, d), aux
