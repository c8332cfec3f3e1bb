"""Single-source-of-truth parameter declarations.

Port of ``repro.models.param``.  Every module declares its parameters as a
tree of :class:`ParamDecl`; :func:`materialize` turns the tree into tensors,
each leaf drawn from a CPU ``torch.Generator`` seeded from the model seed and
the sha256 digest of the leaf's tree path (the reference's ``fold_in`` of the
same digest), so the draws do not depend on traversal order and are the same
on every device.  The draws differ from ``jax.random``'s by design:
``repro_torch.convert.lm_params_from_reference`` carries the reference's
tree across where the two must agree.

The mesh machinery (``spec``, ``specs``, ``abstract``) has no counterpart:
the port runs on one card.
"""
from __future__ import annotations

import hashlib
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


def _draw(d: ParamDecl, gen: torch.Generator) -> torch.Tensor:
    if d.init == "ones":
        return torch.ones(d.shape)
    if d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        return torch.randn(d.shape, generator=gen) * float(d.scale / np.sqrt(fan_in))
    if d.init == "std":  # direct standard deviation (scale IS the std)
        return torch.randn(d.shape, generator=gen) * d.scale
    # "zeros", "ssm_a" and "ssm_dt" come with the families that declare them
    raise ValueError(f"unknown init {d.init}")


def materialize(decls, seed: int | torch.Generator, path: str = "", *, device=None):
    """Instantiate parameters on ``device``; leaf ``p`` is drawn from a CPU
    generator seeded by ``(seed, sha256(path + keystr(p)))``, ``keystr`` in
    ``jax.tree_util.keystr``'s form (``['blocks']['attn']['wq']``).  A
    generator for ``seed`` gives the base seed by one draw."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**62, (1,), generator=seed))

    def build(tree, keypath):
        if isinstance(tree, dict):
            return {k: build(v, f"{keypath}[{k!r}]") for k, v in tree.items()}
        gen = torch.Generator().manual_seed(_leaf_seed(seed, keypath))
        return _draw(tree, gen).to(device=device, dtype=tree.dtype)

    return build(decls, path)


def stack_decls(decls, n: int):
    """Stack every decl with a leading layer axis."""
    if isinstance(decls, dict):
        return {k: stack_decls(v, n) for k, v in decls.items()}
    return decls.stacked(n)


def param_count(decls) -> int:
    if isinstance(decls, dict):
        return sum(param_count(v) for v in decls.values())
    return int(np.prod(decls.shape))
