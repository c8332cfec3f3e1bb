"""Single-source-of-truth parameter declarations.

Port of ``repro.models.param``.  Every module declares its parameters as a
tree of :class:`ParamDecl`; :func:`materialize` turns the tree into tensors,
each leaf drawn from a CPU ``torch.Generator`` seeded from the model seed and
the sha256 digest of the leaf's tree path (the reference's ``fold_in`` of the
same digest), so the draws do not depend on traversal order and are the same
on every device.  The draws differ from ``jax.random``'s by design:
``repro_torch.convert.lm_params_from_reference`` carries the reference's
tree across where the two must agree.

A leaf is drawn in flat chunks of ``CHUNK`` elements, each scaled, cast and
copied into the leaf on ``device`` as it comes, so the host holds one chunk
of a leaf at a time (deepseek-v2-lite's stacked experts are 4.98 G draws,
19.8 GiB of fp32).  Consecutive ``torch.randn`` calls on one generator give
the whole draw bit for bit when every chunk but the last holds a multiple of
16 elements and the last at least 16: the CPU's normal fill draws one
uniform an element, transforms them 16 at a time, and redraws a tail that
16 does not divide as the last 16.  Leaves have their own generators, so
they are drawn on ``THREADS`` host threads at once with the same values.

The mesh machinery (``spec``, ``specs``, ``abstract``) has no counterpart:
the port runs on one card.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    init: str = "normal"  # "normal" | "ones" | "std"
    dtype: Any = torch.float32
    scale: float = 1.0

    def stacked(self, n: int) -> "ParamDecl":
        """Prepend a layer axis (the reference scans over it)."""
        return ParamDecl((n, *self.shape), self.init, self.dtype, self.scale)


def _leaf_seed(seed: int, path: str) -> int:
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "big")
    return (int(seed) * 0x9E3779B97F4A7C15 + digest) % (2**63 - 1)


CHUNK = 1 << 24  # elements a host draw (64 MiB of fp32); a multiple of 16
THREADS = min(8, os.cpu_count() or 1)  # host threads drawing leaves at once


def _std(d: ParamDecl) -> float:
    if d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        return float(d.scale / np.sqrt(fan_in))
    if d.init == "std":  # direct standard deviation (scale IS the std)
        return float(d.scale)
    # "zeros", "ssm_a" and "ssm_dt" come with the families that declare them
    raise ValueError(f"unknown init {d.init}")


def _draw(d: ParamDecl, gen: torch.Generator, device) -> torch.Tensor:
    """The leaf on ``device``: ``randn(shape) * std`` from ``gen`` on the
    host, in flat chunks of ``CHUNK`` elements (the last chunk takes the
    remainder and at least 16), each scaled on ``device`` and cast into the
    leaf's dtype."""
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    std = _std(d)
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    flat, total, a = out.view(-1), out.numel(), 0
    while a < total:
        b = a + CHUNK if total - a - CHUNK >= 16 else total
        flat[a:b] = torch.randn((b - a,), generator=gen).to(device) * std
        a = b
    return out


def materialize(decls, seed: int | torch.Generator, path: str = "", *, device=None):
    """Instantiate parameters on ``device``; leaf ``p`` is drawn from a CPU
    generator seeded by ``(seed, sha256(path + keystr(p)))``, ``keystr`` in
    ``jax.tree_util.keystr``'s form (``['blocks']['attn']['wq']``).  A
    generator for ``seed`` gives the base seed by one draw.  The leaves are
    drawn on ``THREADS`` host threads, the largest first."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**62, (1,), generator=seed))
    leaves = []

    def collect(tree, keypath):
        if isinstance(tree, dict):
            return {k: collect(v, f"{keypath}[{k!r}]") for k, v in tree.items()}
        leaves.append((keypath, tree))
        return keypath

    skeleton = collect(decls, path)

    def draw(item):
        keypath, d = item
        gen = torch.Generator().manual_seed(_leaf_seed(seed, keypath))
        return keypath, _draw(d, gen, device)

    order = sorted(leaves, key=lambda item: -int(np.prod(item[1].shape)))
    with ThreadPoolExecutor(max_workers=max(1, min(len(order), THREADS))) as pool:
        drawn = dict(pool.map(draw, order))

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return drawn[tree]

    return build(skeleton)


def stack_decls(decls, n: int):
    """Stack every decl with a leading layer axis."""
    if isinstance(decls, dict):
        return {k: stack_decls(v, n) for k, v in decls.items()}
    return decls.stacked(n)


def param_count(decls) -> int:
    if isinstance(decls, dict):
        return sum(param_count(v) for v in decls.values())
    return int(np.prod(decls.shape))
