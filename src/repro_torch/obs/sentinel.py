"""Plane sentinels: count the argument signatures each plane is called with.

Port of ``repro.obs.sentinel``.  The reference counts jit (re)traces per
compiled plane (the batched round, the async flush, the warm-up, each serving
bucket), so a shape- or dtype-unstable argument that makes XLA retrace every
call fails a gate instead of silently slowing the loop.  The port compiles
nothing, so the counter counts what would have retraced: :func:`wrap` returns
a callable that bumps its plane the first time it sees a new **argument
signature**, which is exactly when ``jax.jit`` traces again:

- a tensor (or numpy array) enters by its place in the argument tree, its
  shape, dtype and device (a traced array);
- a Python ``bool``, ``int`` or ``float`` by its type alone (``jax.jit``
  traces a Python number as a weakly typed scalar, so a round index or a
  ``do_clf`` flag that changes every call does not retrace);
- any other hashable (a string, ``None``) by its value (a static argument);
- dicts, lists and tuples by their structure, recursively.

Each wrapped callable keeps its own set of signatures seen, as each
``jax.jit`` object keeps its own cache.  Counts are process-global and
monotone, and land in the metrics registry as the counter ``jit.retraces``
labelled by plane (the reference's name, so both packages' benches read one
schema); callers snapshot :func:`counts` before and after a run, and
:func:`assert_stable` fails unless each plane saw exactly ``expect``
signatures.  The bump reads only shapes, dtypes and devices, never a value,
so outputs with and without the sentinel are bit for bit the same.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.obs import registry as _registry

_COUNTS: dict[str, int] = {}


def bump(plane: str) -> None:
    """Record one new signature of ``plane``."""
    _COUNTS[plane] = _COUNTS.get(plane, 0) + 1
    _registry.get_registry().counter("jit.retraces").inc(plane=plane)


def signature(tree):
    """The hashable signature of an argument tree (see the module docstring)."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, np.ndarray):
        return ("array", tree.shape, tree.dtype.str)
    if isinstance(tree, (bool, int, float, np.number)):
        return ("scalar", type(tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(signature(t) for t in tree))
    return ("static", tree)


def wrap(plane: str, fn):
    """``fn`` that bumps ``plane`` at each argument signature it has not seen."""
    seen: set = set()

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        sig = signature((args, kwargs))
        if sig not in seen:
            seen.add(sig)
            bump(plane)
        return fn(*args, **kwargs)

    return traced


def counts() -> dict[str, int]:
    """Snapshot of signatures per plane since process start (or last reset)."""
    return dict(_COUNTS)


def count(plane: str) -> int:
    return _COUNTS.get(plane, 0)


def reset() -> None:
    _COUNTS.clear()


def assert_stable(before: dict[str, int], planes: tuple[str, ...], *,
                  expect: int = 1) -> None:
    """Fail unless each plane saw exactly ``expect`` new signatures since
    ``before`` (a :func:`counts` snapshot).  ``expect=1``: the plane was
    called with one signature and every later call matched it."""
    after = counts()
    bad = {
        p: after.get(p, 0) - before.get(p, 0)
        for p in planes
        if after.get(p, 0) - before.get(p, 0) != expect
    }
    if bad:
        raise AssertionError(
            f"planes retraced: {bad} (expected {expect} signature(s) each) "
            "— a shape/dtype-unstable argument would defeat the jit cache"
        )
