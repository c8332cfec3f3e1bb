"""Functional optimizers over parameter trees: SGD (+momentum), Adam, AdamW.

Port of ``repro.optim.optimizers``.  The interface is the reference's
init/update pair, so the same call sites work under ``torch.func.vmap``:

    opt = adam(lr=5e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Adam keeps the reference's arithmetic: bias corrections ``1 - b1**step``
computed in float32 from an int32 step, and ``eps`` added after the square
root; its moments are fp32 whatever the parameters' dtype.  The schedules
take the step as a tensor, as ``_lr_at`` hands it over.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(step=_step0(params), momentum=mom)

    def update(grads, state, params=None):
        del params
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
            if nesterov:
                upd = tree_map(lambda m, g: -lr_t * (momentum * m + g), mom, grads)
            else:
                upd = tree_map(lambda m: -lr_t * m, mom)
            return upd, SGDState(step=step, momentum=mom)
        return tree_map(lambda g: -lr_t * g, grads), SGDState(step=step, momentum=None)

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; with ``weight_decay > 0`` this is AdamW (decoupled decay)."""

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        z2 = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(step=_step0(params), mu=z, nu=z2)

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)

        def upd_leaf(m, v, p):
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.float()
            return u.to(p.dtype if p is not None else u.dtype)

        if weight_decay:
            if params is None:
                raise ValueError("adamw requires params for decoupled weight decay")
            upd = tree_map(upd_leaf, mu, nu, params)
        else:
            upd = tree_map(lambda m, v: upd_leaf(m, v, None), mu, nu)
            if params is not None:
                upd = tree_map(lambda u, p: u.to(p.dtype), upd, params)
        return upd, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, global_norm).  As in the reference, where a
    bf16 leaf times the fp32 scale promotes to fp32, the clipped leaves are
    at least fp32."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
                    grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def sched(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return sched


def linear_schedule(base_lr: float, total: int, end_frac: float = 0.0):
    def sched(step):
        prog = torch.clamp(step.to(torch.float32) / max(total, 1), 0.0, 1.0)
        return base_lr * (1 - (1 - end_frac) * prog)

    return sched
