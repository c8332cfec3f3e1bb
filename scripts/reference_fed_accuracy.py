#!/usr/bin/env python3
"""Target accuracy of FedRF-TCA at chip_smoke.py's F and H settings, over seeds.

``chip_smoke.py`` trains the PyTorch port at the ``fedrf_paper`` width
(p = 16, extractor (64, 32), N = 512, m = 32, 5 classes, lambda 2, lr 5e-3,
T_C = 50) on ``make_domains(5, 400, shift=1.2, seed=3)`` with 50 warm-up
rounds and 100 rounds, from seed 0.  This script runs one package's
``FedRFTCATrainer`` on the CPU at the same settings for a few seeds and
prints its target accuracy after warm-up and at the end:

  F  batched engine, wire transport, qint8, drop setting III;
  H  batched engine, identity transport, float32, every client every round.

``--package repro`` (the JAX reference, the default) or ``--package
repro_torch`` (the port, ``device="cpu"``); one process imports only the
one package.  Each package draws its starting weights and channel uniforms
from its own generators, so the two are compared on the spread over seeds,
not run for run.  Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_fed_accuracy.py --seeds 0 1 2
    PYTHONPATH=src python scripts/reference_fed_accuracy.py --package repro_torch --seeds 0 1 2
"""
from __future__ import annotations

import argparse
import importlib
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("repro", "repro_torch"), default="repro")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=100)
    args = ap.parse_args()

    fed = importlib.import_module(f"{args.package}.federated")
    netsim = importlib.import_module(f"{args.package}.comm.netsim")
    data = importlib.import_module(f"{args.package}.data")
    device = {"device": "cpu"} if args.package == "repro_torch" else {}

    cfg = fed.ClientConfig(input_dim=16, n_classes=5, extractor_widths=(64, 32), n_rff=512, m=32,
                           lambda_mmd=2.0)
    doms = data.make_domains(5, 400, shift=1.2, seed=3)
    full = netsim.TraceScenario([fed.RoundPlan([0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3])],
                                cycle=True)
    runs = {"F": dict(transport="wire", codec="qint8"), "H": dict(scenario=full)}
    for seed in args.seeds:
        for tag, kw in runs.items():
            t0 = time.perf_counter()
            proto = fed.ProtocolConfig(n_rounds=args.rounds, t_c=50, warmup_rounds=args.warmup,
                                       lr=5e-3, drop_setting="III", seed=seed, engine="batched",
                                       **kw)
            tr = fed.FedRFTCATrainer(doms[:4], doms[4], cfg, proto, **device)
            warm = tr.evaluate()
            tr.train()
            print(json.dumps({"package": args.package, "run": tag, "seed": seed,
                              "acc_after_warmup": float(warm), "acc_end": float(tr.evaluate()),
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
