#!/usr/bin/env python3
"""Where a MoE model's prefill and decode step spend the card's time.

Builds ``--arch`` (``qwen3-moe-235b-a22b`` or ``deepseek-v2-lite-16b``; depth
cut to ``--layers`` when given, as ``chip_smoke.py``'s Q cell cuts qwen3 to
4 of its 94 layers) in bf16 from ``LM.init(0)``, prefills ``chip_smoke.py``'s
M_BATCH x M_PROMPT seeded prompts and takes a decode step, both warm, then
profiles 2 prefills and 5 decode steps apart through ``device_profile``.
Prints one JSON object with, for the prefill and for the decode step: the
host-clock time of each call, the device's busy time and the idle share of
the profiled window, the CUDA time per call by kernel group and by kernel
name (top ``--top``), the aten ops a call dispatches, and the card's name
and power limit.

    python3 scripts/profile_moe_serve.py --arch qwen3-moe-235b-a22b --layers 4
    python3 scripts/profile_moe_serve.py --arch deepseek-v2-lite-16b

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
        print("profile_moe_serve: no CUDA device available", file=sys.stderr)
        return 2
    from torch.utils._python_dispatch import TorchDispatchMode

    from chip_smoke import M_BATCH, M_PROMPT
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
    prompts = torch.randint(0, cfg.vocab_size, (M_BATCH, M_PROMPT),
                            generator=torch.Generator().manual_seed(0)).to(dev)
    _, cache = model.prefill(params, {"tokens": prompts})
    cache = serve.grow_cache(cache, 1)
    tok = prompts[:, -1:]
    calls = {"prefill": (lambda: model.prefill(params, {"tokens": prompts}), PREFILLS),
             "decode_step": (lambda: model.decode_step(params, cache, {"tokens": tok},
                                                       M_PROMPT), STEPS)}
    out = {}
    for what, (fn, n) in calls.items():
        fn()
        torch.cuda.synchronize()
        with OpCount() as ops:
            fn()
        out[what] = {**profile_calls(fn, n, args.top), "aten_ops_per_call": ops.n}
    print(json.dumps({"card": card(), "arch": args.arch, "n_layers": cfg.n_layers,
                      "batch": M_BATCH, "prompt": M_PROMPT, **out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
