"""Where a call spends the card's time: the profiled window that
``profile_train_step.py`` and ``profile_moe_serve.py`` share.

``profile_calls(fn, n)`` runs ``fn`` ``n`` times inside ``torch.profiler``
(CPU and CUDA activities), each call ending in ``synchronize``, and returns
the host-clock time of each call, the device's busy time summed over its
kernels and the idle share of the window, the CUDA time per call by kernel
group (``group``) and by kernel name (the top ``top``, names cut to 120
characters).  ``card()`` is the card's name and power limit as
``nvidia-smi`` gives them.
"""
from __future__ import annotations

import subprocess
import time


def group(name: str) -> str:
    """The kernel group a CUDA kernel's name falls in."""
    low = name.lower()
    if "flash_bwd" in name:
        return "attention backward (K11b)"
    if "flash_bf16" in name or "flash_f32" in name:
        return "attention forward (K11)"
    if any(k in name for k in ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")):
        return "matrix products"
    if any(k in low for k in ("sort", "scan", "cumsum")):
        return "sorts and scans"
    if any(k in low for k in ("index", "gather", "scatter")):
        return "indexing"
    if "reduce" in low:
        return "reductions"
    return "elementwise, copies and the rest"


def profile_calls(fn, n: int, top: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    call_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
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
    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms / n
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "calls": n, "call_ms": call_ms, "window_ms": window_ms,
        "device_busy_ms_per_call": busy / n,
        "device_idle_share": max(0.0, 1 - busy / window_ms),
        "groups_ms_per_call": dict(sorted(groups.items())),
        "top_kernels_ms_per_call": {k[:120]: v / n for k, v in ranked},
    }


def card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return smi[0] if smi else torch.cuda.get_device_name(0)
