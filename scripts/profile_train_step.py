#!/usr/bin/env python3
"""Where a training step of the LM backbone spends the card's time.

Runs ``chip_smoke.py``'s T cell (smollm-135m as its config gives it: 30
layers, bf16, remat, the FDA head on 2 clients; 8 x 2048 tokens from
``TokenStream(49152, 8, 2048, seed=1)``; AdamW(cosine(3e-4, 10, 30), wd
0.01) through ``launch.train.build_train_step``) for a few warm-up steps,
then profiles ``--steps`` steps with ``torch.profiler`` (CPU and CUDA
activities) through ``device_profile``.  Prints one JSON object: the
steps' host-clock times, the device's busy time and the idle share of the
profiled window, the CUDA time per step by kernel group (attention forward
(K11), attention backward (K11b), matrix products, sorts and scans,
indexing, reductions and the rest) and by kernel name (top ``--top``), and
the card's name and power limit.

    python3 scripts/profile_train_step.py [--steps 3] [--top 25]

Run from the root of a checkout on a machine with one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from device_profile import card, profile_calls
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw, cosine_schedule

    dev = torch.device("cuda")
    cfg = get_config("smollm-135m")
    model = LM(cfg)
    opt = adamw(cosine_schedule(3e-4, warmup=10, total=30), weight_decay=0.01)
    step = build_train_step(model, opt, 2)
    params = model.init(0, device=dev)
    state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, 8, 2048, seed=1)
    batches = iter([{k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
                    for _ in range(args.warmup + args.steps)])

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, next(batches))

    for _ in range(args.warmup):
        one_step()
    print(json.dumps({"card": card(), **profile_calls(one_step, args.steps, args.top)},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
