"""One run of one cell: set-up, the measured window, the check.

``run_cell`` builds the cell's loop (its set-up: data on the device from the
seed, sigma, the warm calls), runs it for ``seconds`` with nothing compiled
inside, closes the window with ``synchronize``, reads the memory peak, and
only then lets the reference judge the sampled answers.  With ``trace`` the
profiler covers a steady sub-window (``trace_skip_seconds`` in, for
``trace_seconds``) and the result carries the per-layer metrics in place of
the end-to-end ones.
"""
from __future__ import annotations

import math
import time

import torch

from portbench import counts, spec
from portbench.drivers.common import sync
from portbench.profiling import Tracer


def _run_until(loop, t_end: float) -> None:
    while time.perf_counter() < t_end:
        loop.step()


def _traced(loop, cell, seconds: float, tracer: Tracer):
    """The window with the profiler over a sub-window of its own length (the
    window runs past ``seconds`` if need be); the view, with the loop's work
    inside it."""
    tr = cell.traffic
    t0 = time.perf_counter()
    _run_until(loop, t0 + tr["trace_skip_seconds"])
    loop.drain()
    before = loop.work()
    tracer.start()
    _run_until(loop, time.perf_counter() + tr["trace_seconds"])
    loop.drain()
    view = tracer.stop(cell.layers)
    view.work = {k: v - before[k] for k, v in loop.work().items()}
    _run_until(loop, t0 + seconds)
    loop.drain()
    return view


def _window(loop, seconds: float) -> float:
    t0 = time.perf_counter()
    _run_until(loop, t0 + seconds)
    loop.drain()
    return time.perf_counter() - t0


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool, device="cuda",
             program=None, t_start: float | None = None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    if program is None:
        from portbench.program import PortProgram

        program = PortProgram()
    loop = spec.driver(cell.traffic["driver"])(cell, seed, device, program)
    tracer = Tracer() if trace else None
    sync(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        view = _traced(loop, cell, seconds, tracer)
    else:
        window_s = _window(loop, seconds)
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    metrics, breakdown = {}, None
    if trace:
        view.counts = counts.for_config(cell.config)
        view.peak = counts.PEAKS.get(dev["kind"])
        for name, unit in cell.per_layer.items():
            value = spec.reader(name)(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        breakdown = view.breakdown()
    else:
        e2e = {**loop.end_to_end(window_s), "setup_s": setup_s}
        metrics = {k: {"value": e2e[k], "unit": u} for k, u in cell.end_to_end.items() if k in e2e}
    attempted = loop.attempted()
    gaps = loop.check()
    checks = {k: {"value": gaps.get(k, math.inf), "limit": lim} for k, lim in cell.limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
