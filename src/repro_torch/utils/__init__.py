"""Tree helpers over nested dicts and lists of tensors (``utils.tree``)."""
from repro_torch.utils.tree import (
    tree_add,
    tree_allclose,
    tree_bytes,
    tree_mean,
    tree_scale,
    tree_size,
    tree_weighted_mean,
    tree_zeros_like,
)

__all__ = [
    "tree_add", "tree_allclose", "tree_bytes", "tree_mean", "tree_scale", "tree_size",
    "tree_weighted_mean", "tree_zeros_like",
]
