"""Tree checkpointing: npz payload + json paths, atomic, last ``keep`` steps.

Port of ``repro.checkpoint.ckpt`` with the same ``.npz`` layout: leaf ``i``
of the tree (JAX's leaf order: dict keys sorted) under ``leaf_i``, the
``/``-joined leaf paths under ``__paths__``.  Either package restores the
other's checkpoint of the same structure; ``__treedef__`` is informative
only (each package writes its own description and neither reads it).
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.utils.tree import (
    host_numpy,
    tree_flatten_with_paths,
    tree_leaves,
    tree_unflatten_like,
)


def save(path: str, tree, step: int | None = None, keep: int = 3) -> str:
    """Save a tree.  With ``step``, writes ``<path>/step_<step>.npz``."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, f"step_{step:08d}.npz")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        target = path if path.endswith(".npz") else path + ".npz"
    paths, leaves = tree_flatten_with_paths(tree)
    # bf16 leaves go in as their float32 values; restore casts them back
    payload = {f"leaf_{i}": host_numpy(leaf) for i, leaf in enumerate(leaves)}
    payload["__paths__"] = np.array(json.dumps(paths))
    payload["__treedef__"] = np.array(f"repro_torch tree of {len(leaves)} leaves")
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(target)), suffix=".tmp")
    os.close(fd)
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, target)
    if step is not None and keep:
        _gc(path, keep)
    return target


def restore(path: str, like):
    """Restore into the structure of ``like`` (shapes validated; each leaf
    takes the dtype, and for tensors the device, of ``like``'s leaf)."""
    if os.path.isdir(path):
        path = latest(path)
        if path is None:
            raise FileNotFoundError("no checkpoints in directory")
    leaves = []
    with np.load(path, allow_pickle=False) as data:
        for i, ref in enumerate(tree_leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(f"leaf {i}: shape {arr.shape} != expected {tuple(np.shape(ref))}")
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.from_numpy(np.array(arr)).to(device=ref.device,
                                                                 dtype=ref.dtype))
            else:
                leaves.append(arr.astype(np.asarray(ref).dtype))
    return tree_unflatten_like(like, leaves)


def latest(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(f for f in os.listdir(ckpt_dir) if re.match(r"step_\d+\.npz$", f))
    return os.path.join(ckpt_dir, files[-1]) if files else None


def latest_step(ckpt_dir: str) -> int | None:
    f = latest(ckpt_dir)
    return int(re.search(r"step_(\d+)", f).group(1)) if f else None


def _gc(ckpt_dir: str, keep: int) -> None:
    files = sorted(f for f in os.listdir(ckpt_dir) if re.match(r"step_\d+\.npz$", f))
    for f in files[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))
