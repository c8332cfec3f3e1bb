"""Chunked and sharded execution over the stacked client axis.

Port of ``repro.fleet.sharding``.  The batched round engine stacks per-client
state on a leading K axis and ``vmap``s the local-step body across it: a
working set proportional to K.  This module bounds it and splits it:

- :func:`chunked_vmap`: a drop-in ``torch.func.vmap`` whose leading axis is
  consumed ``chunk`` rows at a time by a Python loop, so one chunk of
  activations and gradients is live at a time (O(chunk), not O(K)).
  ``chunk=None`` (or chunk >= K) is plain ``vmap``, bit for bit.  K that does
  not divide by the chunk pads the last chunk by repeating row 0 (finite
  values: zero rows would hit the extractor's unit-norm NaN gradient) and
  slices the padding off after.
- :func:`client_mesh` / :func:`sharded_client_map`: the K axis split over the
  mesh's devices, each shard running :func:`chunked_vmap` on its rows.  The
  local step has no cross-client dependency, so nothing is reduced across
  shards; the cross-client work is the edge and server merges.  On one card
  the split is the identity.

:func:`working_set_proxy` is the measurable twin of the O(chunk) claim: the
largest intermediate a compute op makes in an aten trace of the function.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.utils.tree import tree_leaves, tree_map


def chunked_vmap(fn, in_axes, *, chunk: int | None):
    """``vmap(fn, in_dims=in_axes)`` evaluated ``chunk`` rows at a time.

    ``in_axes`` is a tuple of ``0`` (mapped on the leading axis) or ``None``
    (broadcast); outputs are mapped on axis 0, like the engine's per-client
    bodies."""
    in_axes = tuple(in_axes)
    vf = vmap(fn, in_dims=in_axes)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive int or None, got {chunk}")

    def run(*args):
        if len(args) != len(in_axes):
            raise ValueError(f"{len(args)} args for in_axes of length {len(in_axes)}")
        mapped = [leaf for a, ax in zip(args, in_axes) if ax == 0 for leaf in tree_leaves(a)]
        if not mapped:
            raise ValueError("chunked_vmap needs at least one mapped (axis-0) argument")
        k = mapped[0].shape[0]
        if chunk is None or chunk >= k:
            return vf(*args)

        def rows(x, lo):
            part = x[lo:lo + chunk]
            pad = chunk - part.shape[0]
            if pad:
                part = torch.cat([part, x[:1].expand((pad,) + tuple(x.shape[1:]))])
            return part

        outs = [vf(*(tree_map(lambda x: rows(x, lo), a) if ax == 0 else a
                     for a, ax in zip(args, in_axes)))
                for lo in range(0, k, chunk)]
        return tree_map(lambda *parts: torch.cat(parts)[:k], *outs)

    return run


def client_mesh(n_shards: int) -> tuple[torch.device, ...]:
    """The first ``n_shards`` CUDA devices: the ``clients`` mesh."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n_shards]
    if len(devs) < n_shards:
        raise ValueError(f"need {n_shards} devices for the clients mesh, have {len(devs)}")
    return tuple(devs)


def sharded_client_map(mesh, fn, in_axes, *, chunk: int | None = None):
    """The (chunked) per-client body with the K axis split over ``mesh``.

    Mapped (axis-0) arguments are split into equal row blocks, one per device
    of the mesh (K must divide by the mesh size); broadcast (``None``)
    arguments are copied to every device.  Each shard runs
    :func:`chunked_vmap` on its rows, and the outputs are gathered on the
    mesh's first device."""
    inner = chunked_vmap(fn, in_axes, chunk=chunk)
    devs = tuple(mesh)

    def run(*args):
        k = next(leaf for a, ax in zip(args, in_axes) if ax == 0
                 for leaf in tree_leaves(a)).shape[0]
        if k % len(devs):
            raise ValueError(f"K={k} does not divide by the mesh size {len(devs)}")
        per = k // len(devs)
        outs = []
        for i, dev in enumerate(devs):
            shard = tuple(tree_map(lambda x: x[i * per:(i + 1) * per].to(dev), a) if ax == 0
                          else tree_map(lambda x: x.to(dev), a)
                          for a, ax in zip(args, in_axes))
            outs.append(inner(*shard))
        return tree_map(lambda *parts: torch.cat([p.to(devs[0]) for p in parts]), *outs)

    return run


# aten ops that only move or repackage data: the stacked (K, ...) state and
# its slices, pads and concatenations are persistent, not the live set
_DATA_MOVEMENT = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "squeeze",
    "unsqueeze", "cat", "constant_pad_nd", "clone", "copy", "copy_", "_to_copy", "slice",
    "select", "gather", "index_select", "flip", "split", "split_with_sizes", "unbind",
    "alias", "detach", "lift_fresh_copy", "repeat",
}


def working_set_proxy(fn, *args) -> int:
    """Largest intermediate (bytes) a compute op makes in the aten trace of
    ``fn(*args)`` (``make_fx`` with fake tensors; pure data-movement ops
    skipped, as the reference skips them in its jaxpr)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(fn, tracing_mode="fake")(*args).graph
    worst = 0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "_opname", None) or str(node.target).split(".")[-2]
        if name in _DATA_MOVEMENT:
            continue
        for val in tree_leaves(node.meta.get("val")):
            if isinstance(val, torch.Tensor):
                worst = max(worst, val.numel() * val.element_size())
    return worst
