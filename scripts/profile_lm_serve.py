#!/usr/bin/env python3
"""Where an LM's prefill and decode step spend the card's time.

Builds ``--arch`` (any architecture: dense, MoE, SSM, hybrid, VLM, audio;
depth cut to ``--layers`` when given, as ``chip_smoke.py``'s Q cell cuts
qwen3 to 4 of its 94 layers and its V cell llama-3.2-vision-90b to 5) in
bf16 from ``LM.init(0)``, prefills ``chip_smoke.py``'s M_BATCH seeded prompts
(M_PROMPT tokens, or U_FRAMES frame embeddings for an ``embeddings_in``
model; zero images for the VLM, as ``serve.request_batch`` makes them) and
takes a decode step, both warm, then profiles 2 prefills and 5 decode steps
apart through ``device_profile``.  Prints one JSON object with, for the
prefill and for the decode step: the host-clock time of each call, the
device's busy time and the idle share of the profiled window, the CUDA time
per call by kernel group and by kernel name (top ``--top``), the aten ops a
call dispatches, and the card's name and power limit.

    python3 scripts/profile_lm_serve.py --arch qwen3-moe-235b-a22b --layers 4
    python3 scripts/profile_lm_serve.py --arch deepseek-v2-lite-16b
    python3 scripts/profile_lm_serve.py --arch mamba2-2.7b

Run from the root of a checkout on a machine with one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PREFILLS, STEPS = 2, 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=0, help="0: the config's depth")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_lm_serve: no CUDA device available", file=sys.stderr)
        return 2
    from torch.utils._python_dispatch import TorchDispatchMode

    from chip_smoke import M_BATCH, M_PROMPT, U_FRAMES
    from device_profile import card, profile_calls
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM

    class OpCount(TorchDispatchMode):
        """Counts the aten ops a call dispatches (views included)."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    model = LM(cfg)
    params = model.init(0, device=dev)
    seq = U_FRAMES if cfg.embeddings_in else M_PROMPT
    batch = {k: v.to(dev) for k, v in serve.request_batch(cfg, M_BATCH, seq).items()}
    _, cache = model.prefill(params, batch)
    cache = serve.grow_cache(cache, 1)
    key = "embeddings" if cfg.embeddings_in else "tokens"
    step = {key: batch[key][:, -1:]}
    calls = {"prefill": (lambda: model.prefill(params, batch), PREFILLS),
             "decode_step": (lambda: model.decode_step(params, cache, step, seq), STEPS)}
    out = {}
    for what, (fn, n) in calls.items():
        fn()
        torch.cuda.synchronize()
        with OpCount() as ops:
            fn()
        out[what] = {**profile_calls(fn, n, args.top), "aten_ops_per_call": ops.n}
    print(json.dumps({"card": card(), "arch": args.arch, "n_layers": cfg.n_layers,
                      "batch": M_BATCH, "prompt": seq, **out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
