"""Readings of the checks' numbers for the control, or for the program, at a
cell's own size: the runs that the limits in ``limits/<cell>.json`` are set
from (step 3 of the benchmark's rule for ``correct``).

    python3 portbench/control.py --workload visda-fit a2w-fit --seeds 11 12 13 \
        --seconds 2 [--program port]

The control (the default) is ``references.rftca.ControlProgram("tf32")``: the
reference in the program's place with its products in TF32, one step below
the float32 that the configurations state.  Each run is a short window at
the cell's own load, checked as the benchmark checks it; one JSON line a run.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", choices=("control", "port"), default="control")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import bench, spec
    from portbench.references.rftca import ControlProgram

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    for name in args.workload:
        cell = spec.load_cell(ROOT, name)
        for seed in args.seeds:
            program = ControlProgram("tf32") if args.program == "control" else None
            r = bench.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                               device="cuda:0", program=program)
            checks = {k: (c["value"] if math.isfinite(c["value"]) else str(c["value"]))
                      for k, c in r["checks"].items()}
            print(json.dumps({"workload": name, "seed": seed, "program": args.program,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": checks}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
