"""Small tree helpers over nested dicts, lists, tuples and NamedTuples of tensors.

Port of ``repro.utils.tree``.  Leaves are visited in JAX's pytree order:
dict keys sorted, lists, tuples and NamedTuple fields in order, ``None`` an
empty subtree.  The checkpoint layout (``leaf_i``) depends on that order, so
either package restores the other's checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> tuple[list, Callable[[list], Any], list]:
    """(children, rebuild, path keys) of one node."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([tree[k] for k in keys],
                lambda ch: dict(zip(keys, ch)), keys)
    if _is_namedtuple(tree):
        return (list(tree), lambda ch: type(tree)(*ch), list(tree._fields))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return (list(tree), lambda ch: kind(ch), list(range(len(tree))))
    raise TypeError("not a tree node")


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_flatten_with_paths(tree) -> tuple[list[str], list]:
    """(``a/b/0/w`` paths, leaves) in pytree order."""
    paths, leaves = [], []

    def walk(t, prefix):
        if t is None:
            return
        if not _is_node(t):
            paths.append("/".join(str(p) for p in prefix))
            leaves.append(t)
            return
        ch, _, keys = _children(t)
        for c, k in zip(ch, keys):
            walk(c, prefix + [k])

    walk(tree, [])
    return paths, leaves


def tree_leaves(tree) -> list:
    return tree_flatten_with_paths(tree)[1]


def tree_unflatten_like(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in pytree order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        ch, rebuild, _ = _children(t)
        return rebuild([build(c) for c in ch])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` leafwise over trees of one structure (``None`` stays ``None``)."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    ch, rebuild, _ = _children(tree)
    others = [_children(r)[0] for r in rest]
    return rebuild([tree_map(fn, c, *(o[i] for o in others)) for i, c in enumerate(ch)])


def tree_size(tree) -> int:
    """Total number of scalar elements in a tree."""
    return int(sum(np.prod(tuple(x.shape)) for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (each leaf's dtype itemsize)."""
    return int(sum(np.prod(tuple(x.shape)) * _itemsize(x) for x in tree_leaves(tree)))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.asarray(x).dtype.itemsize


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_mean(trees):
    """Elementwise mean of a non-empty list of trees (FedAvg aggregation)."""
    if not trees:
        raise ValueError("tree_mean of empty list")
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_weighted_mean(trees, weights):
    """Weighted mean of trees; weights normalised to sum 1 (FedAvg with sizes)."""
    if not trees:
        raise ValueError("tree_weighted_mean of empty list")
    ws = np.asarray(weights, dtype=np.float64)
    ws = ws / ws.sum()
    acc = tree_scale(trees[0], float(ws[0]))
    for t, w in zip(trees[1:], ws[1:]):
        acc = tree_add(acc, tree_scale(t, float(w)))
    return acc


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.allclose(host_numpy(x), host_numpy(y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb))


def host_numpy(x) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 (which numpy lacks) as its
    exact float32 value."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def stack_trees(trees: list):
    """List of identically shaped trees -> one tree of (K, ...) leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_tree(tree, i: int):
    """Row i of a stacked tree (client i's parameters)."""
    return tree_map(lambda x: x[i], tree)


def tree_where(pred: torch.Tensor, new, old):
    """Leafwise ``torch.where(pred, new, old)``: a conditional assignment
    decided on the device (``pred`` a 0-d bool tensor)."""
    return tree_map(lambda a, b: torch.where(pred, a, b), new, old)
