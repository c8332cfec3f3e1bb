"""End-to-end FedRF-TCA run (paper Algorithm 5) on the PyTorch port:
multi-source federated domain adaptation over an unreliable network, with
communication accounting (``examples/federated_adaptation.py`` on the JAX
reference).

    PYTHONPATH=src python examples/torch_federated_adaptation.py [--rounds 300]
    PYTHONPATH=src python examples/torch_federated_adaptation.py --device cpu

Four source clients + one unlabeled target client, shared-seed RFF compressor,
FedAvg of W_RF every round and classifiers every T_C rounds, under message-drop
setting (III) — the harshest of Table III.

``--async`` swaps the lockstep round loop for the event-driven fedsim runtime:
clients churn on a seeded Markov on/off trace, their uplinks land after
link-model latencies, and the server aggregates a FedBuff-style buffer with
polynomial staleness weighting — the same adaptation problem, advanced on a
virtual clock instead of a round counter.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.data import make_domains
from repro_torch.device import resolve_device
from repro_torch.federated import ClientConfig, FedRFTCATrainer, ProtocolConfig
from repro_torch.federated.model import accuracy


def run_async(tr, args) -> dict:
    """Churny event-driven run: report accuracy against virtual time."""
    from repro_torch.comm.netsim import LinkModel, LinkScenario
    from repro_torch.fedsim import AsyncConfig, AsyncScheduler, markov_trace

    k = len(tr.sources)
    links = LinkScenario(
        links=[LinkModel(latency_s=0.2 * (i + 1), bandwidth_bps=1e5) for i in range(k)]
    )
    avail = markov_trace(
        k, horizon=500.0 * args.rounds, mean_on=20.0,
        mean_off=20.0 * args.churn / max(1.0 - args.churn, 1e-6), seed=1,
    )
    sched = AsyncScheduler(
        tr,
        AsyncConfig(buffer_size=max(k // 2, 1), staleness="polynomial"),
        availability=avail if args.churn > 0 else None,
        links=links,
    )
    uplink_bytes = sum(sched.payload_bytes.get(k, 0) for k in ("moments", "w_rf"))
    print(
        f"async runtime: buffer={sched.cfg.buffer_size}, churn fraction ~{args.churn:.0%}, "
        f"uplink bytes={uplink_bytes}"
    )
    hist = sched.run(args.rounds, eval_every=max(args.rounds // 8, 1))
    evals = []
    for h in hist:
        if "acc" in h:
            stale = max(h["staleness"])
            evals.append((h["t"], h["flush"], h["acc"]))
            print(
                f"virtual t={h['t']:8.1f}s  flush {h['flush']:4d}  "
                f"target acc = {h['acc']:.3f}  (buffer staleness max {stale})"
            )
    final = tr.evaluate()
    print(f"\nfinal target accuracy: {final:.3f} after {sched.flushes} buffered flushes")
    print(f"virtual wall-clock: {sched.clock.now:.1f}s; churned clients resumed with "
          f"stale aligners and their updates were staleness-discounted at the merge.")
    return {"final": final, "flushes": sched.flushes, "virtual_s": sched.clock.now,
            "evals": evals, "uplink_bytes": uplink_bytes}


def run(args, device=None) -> dict:
    """The run's numbers: the warm-up and final target accuracy, the
    accuracy and uplink after each quarter of the rounds (``--async``: the
    final accuracy, flushes, virtual time and the evaluations)."""
    dev = resolve_device(device if device is not None else args.device)
    doms = make_domains(5, 400, shift=1.2, seed=3)
    sources, target = doms[:4], doms[4]
    cfg = ClientConfig(input_dim=16, n_classes=5, n_rff=128, m=16, lambda_mmd=2.0)
    proto = ProtocolConfig(
        n_rounds=args.rounds, t_c=25, warmup_rounds=args.warmup, lr=5e-3,
        drop_setting=args.setting, seed=0,
    )
    print(f"== FedRF-TCA: {len(sources)} sources -> 1 target, drop setting ({args.setting}) ==")
    tr = FedRFTCATrainer(sources, target, cfg, proto, device=dev)
    if args.use_async:
        return run_async(tr, args)
    xt = torch.as_tensor(target.x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(target.y, device=dev)
    warm = float(accuracy(tr.tgt_params, tr.omega, xt, yt))
    print(f"after FedAvg warm-up ({args.warmup} rounds): target acc = {warm:.3f}")

    blocks = []
    for block in range(4):
        n = args.rounds // 4
        for t in range(1, n + 1):
            tr.round(block * n + t)
        acc = tr.evaluate()
        per_round = tr.comm.total / tr.comm.rounds
        blocks.append({"round": (block + 1) * n, "acc": acc, "uplink_per_round": per_round})
        print(
            f"round {(block+1)*n:4d}: target acc = {acc:.3f} "
            f"(uplink {per_round:,.0f} floats/round, "
            f"{tr.comm.data_messages/tr.comm.rounds:,.0f} of which are Sigma-ell messages)"
        )
    final = tr.evaluate()
    print(f"\nfinal target accuracy: {final:.3f} (warm-up was {warm:.3f})")
    print("message size is 2N =", 2 * cfg.n_rff, "floats — independent of client data size.")
    return {"warm": warm, "final": final, "blocks": blocks, "message_floats": 2 * cfg.n_rff}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--setting", default="III", choices=["I", "II", "III"])
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="event-driven fedsim runtime: churn + buffered aggregation")
    ap.add_argument("--churn", type=float, default=0.3,
                    help="offline fraction of the Markov churn trace (with --async)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    out = run(args)
    if not args.use_async:
        assert out["final"] > out["warm"], "adaptation should improve on the warm-up transfer"


if __name__ == "__main__":
    main()
