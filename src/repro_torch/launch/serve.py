"""Serving driver: prefill a batch of prompts, then decode greedily.

Port of ``repro.launch.serve``; runs on the CUDA card unless ``--device``
says otherwise:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --prompt-len 2048 --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --prompt-len 2048 --gen 16 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Any dense or MoE architecture serves, with GQA or MLA attention; prefill
attention goes through the K11 kernel on the card.  Weights are drawn
from seed 0 by ``LM.init`` and the prompts from a seeded CPU generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import LM

# every attention-cache leaf grows along axis 2 (the sequence axis), whether
# it is a plain KV pair, a windowed variant, or an MLA latent/rope column
_CACHE_GROW_KEYS = ("k", "v", "attn_k", "attn_v", "c", "kr")


def grow_cache(tree, extra: int, *, keys: tuple[str, ...] = _CACHE_GROW_KEYS):
    """Pad every cache leaf under a growable key by ``extra`` zero slots on the
    sequence axis (axis 2), recursing through nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = grow_cache(v, extra, keys=keys)
        elif k in keys:
            pad = [0, 0] * v.ndim  # F.pad lists the last axis first
            pad[2 * (v.ndim - 3) + 1] = extra
            out[k] = F.pad(v, pad)
        else:
            out[k] = v
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: LM, params, prompts: torch.Tensor, gen: int) -> dict:
    """Prefill ``prompts`` (b, s) and decode ``gen`` tokens greedily
    (``argmax(logits[:, :vocab_size])``), on the prompts' device.

    Returns ``tokens`` (b, gen) int64 on the CPU, ``logits`` (``gen`` tensors
    (b, vocab_padded): the prefill's, then each decode step's), ``prefill_s``
    (the prefill, the cache growth and the first token's copy to the host)
    and ``step_ms`` (each decode step, ending in its token's copy)."""
    if gen < 1:
        raise ValueError(f"gen {gen} < 1")
    vocab = model.cfg.vocab_size
    dev = prompts.device
    s = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts})
    cache = grow_cache(cache, gen)  # room for the generated tokens
    tok = torch.argmax(logits[:, :vocab], dim=-1)[:, None]
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    all_logits, step_ms = [logits], []
    for i in range(gen - 1):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, {"tokens": tok}, s + i)
        tok = torch.argmax(logits[:, :vocab], dim=-1)[:, None]
        out.append(tok.cpu())
        step_ms.append((time.perf_counter() - t1) * 1e3)
        all_logits.append(logits)
    return {"tokens": torch.cat(out, dim=1), "logits": all_logits, "prefill_s": prefill_s,
            "step_ms": step_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg)
    params = model.init(0, device=dev)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen)
    res = generate(model, params, prompts.to(dev), args.gen)
    t_decode = sum(res["step_ms"]) / 1e3
    tokens = res["tokens"].numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"prefill {args.prompt_len} toks x{args.batch}: {res['prefill_s']:.2f}s")
    print(f"decode  {args.gen-1} steps x{args.batch}: {t_decode:.2f}s ({tps:,.1f} tok/s)")
    print("sample:", tokens[0][:16])
    assert np.isfinite(tokens).all()
    return {"prefill_s": res["prefill_s"], "decode_s": t_decode, "tokens": tokens}


if __name__ == "__main__":
    main()
