"""Downstream classifiers that score aligned features (paper App. D uses an
FCNN (2 x 100), SVM-RBF and 1-NN; here the FCNN, logistic regression, 1-NN).

Port of ``repro.baselines.classifiers``.  Initial weights are drawn on a CPU
``torch.Generator`` and copied to the device, so the card and the CPU start
from one state (not the reference's ``jax.random`` draws: the tests hand the
reference's initial weights to :func:`train_mlp`).  Training is full-batch
Adam on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import as_f32, resolve_device
from repro_torch.optim import adam, apply_updates
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


def adam_train(params, loss_fn, *, steps: int, lr: float):
    """``steps`` full-batch Adam steps on ``loss_fn(params)``; returns the
    trained parameter tree."""
    opt = adam(lr)
    state = opt.init(params)
    for _ in range(steps):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        grads = torch.autograd.grad(loss_fn(live), tree_leaves(live))
        with torch.no_grad():
            updates, state = opt.update(tree_unflatten_like(live, list(grads)), state, params)
            params = apply_updates(params, updates)
    return params


def mlp_init(widths: tuple[int, ...], seed: int, *, device=None) -> list[dict]:
    """He-normal weights, zero biases: ``[{"w": (din, dout), "b": (dout,)}]``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return [{"w": (torch.randn((din, dout), generator=gen) * math.sqrt(2.0 / din)).to(dev),
             "b": torch.zeros((dout,), device=dev)}
            for din, dout in zip(widths[:-1], widths[1:])]


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def softmax_ce(logits: torch.Tensor, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Mean CE against one-hot labels, the reference's formula."""
    oh = F.one_hot(y, n_classes).to(logits.dtype)
    return -torch.mean(torch.sum(oh * torch.log_softmax(logits, dim=-1), dim=-1))


def train_mlp(params: list[dict], x: torch.Tensor, y: torch.Tensor, n_classes: int, *,
              steps: int = 300, lr: float = 1e-2) -> list[dict]:
    """:func:`fit_mlp`'s loop from given initial weights (x (n, d) fp32, y
    (n,) int64, on the weights' device)."""
    return adam_train(params, lambda p: softmax_ce(mlp_apply(p, x), y, n_classes), steps=steps,
                      lr=lr)


def fit_mlp(
    feats: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    *,
    hidden: tuple[int, ...] = (100, 100),
    steps: int = 300,
    lr: float = 1e-2,
    seed: int = 0,
    device=None,
):
    """Train the paper's FCNN (two hidden layers, 100 units) on (n, d)
    features; returns ``predict(feats) -> labels`` (numpy)."""
    dev = resolve_device(device)
    x = as_f32(feats, dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    params = mlp_init((x.shape[1],) + tuple(hidden) + (n_classes,), seed, device=dev)
    params = train_mlp(params, x, y, n_classes, steps=steps, lr=lr)

    def predict(xx):
        with torch.no_grad():
            return torch.argmax(mlp_apply(params, as_f32(xx, dev)), dim=-1).cpu().numpy()

    return predict


def fit_logreg(feats, labels, n_classes, **kw):
    return fit_mlp(feats, labels, n_classes, hidden=(), **kw)


def knn_1(train_feats: np.ndarray, train_labels: np.ndarray, *, device=None):
    """1-nearest-neighbour in feature space (paper's kNN, k=1), distances in
    fp32 on the device."""
    dev = resolve_device(device)
    xt = as_f32(train_feats, dev)
    yt = np.asarray(train_labels)

    def predict(xx):
        xq = as_f32(xx, dev)
        d = (torch.sum(xq * xq, 1)[:, None] - 2 * xq @ xt.T
             + torch.sum(xt * xt, 1)[None, :])
        return yt[torch.argmin(d, dim=1).cpu().numpy()]

    return predict


def score(predict, feats, labels) -> float:
    return float(np.mean(predict(feats) == np.asarray(labels)))
