"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the cells are in ``BENCHMARK.json``, the
program is ``src/repro_torch``, its CUDA libraries are built into
``build/kernels/`` (hash-keyed, so only a checkout's first run compiles) and
any other kernel cache of the process goes under ``build/``.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the last lines of
standard error repeat the checks.  With no CUDA card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _finite(x):
    """The result with non-finite numbers written as strings (JSON has none)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import bench, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = bench.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                            device="cuda:0", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
