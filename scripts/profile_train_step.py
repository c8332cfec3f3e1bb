#!/usr/bin/env python3
"""Where a training step of the LM backbone spends the card's time.

Runs ``chip_smoke.py``'s T cell (smollm-135m as its config gives it: 30
layers, bf16, remat, the FDA head on 2 clients; 8 x 2048 tokens from
``TokenStream(49152, 8, 2048, seed=1)``; AdamW(cosine(3e-4, 10, 30), wd
0.01) through ``launch.train.build_train_step``) for a few warm-up steps,
then profiles ``--steps`` steps with ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON object: the steps' host-clock times (each
ending in ``synchronize``), the device's busy time summed over its kernels
and the idle share of the profiled window, the CUDA time by kernel name
(top ``--top``; each kernel name shortened to its first 120 characters),
grouped into attention forward (K11), attention backward (K11b), matrix
products, reductions and the rest, and the card's name and power limit.

    python3 scripts/profile_train_step.py [--steps 3] [--top 25]

Run from the root of a checkout on a machine with one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
               for _ in range(args.warmup + args.steps)]
    for b in batches[:args.warmup]:
        params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for b in batches[args.warmup:]:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        window_ms = (time.perf_counter() - t_window) * 1e3
    # kernels only: the CPU-side ops and autograd nodes carry their kernels'
    # device time too, and would count it twice
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())

    def group(name: str) -> str:
        if "flash_bwd" in name:
            return "attention backward (K11b)"
        if "flash_bf16" in name or "flash_f32" in name:
            return "attention forward (K11)"
        if any(k in name for k in ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")):
            return "matrix products"
        if "reduce" in name.lower():
            return "reductions"
        return "elementwise, copies and the rest"

    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    top = [(k[:120], v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]]
    print(json.dumps({
        "card": smi[0] if smi else torch.cuda.get_device_name(0),
        "steps": args.steps, "step_ms": step_ms, "window_ms": window_ms,
        "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / window_ms),
        "groups_ms_per_step": {k: v / args.steps for k, v in sorted(groups.items())},
        "top_kernels_ms_per_step": {k: v / args.steps for k, v in top},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
