"""Closed loop of fits by one fitter.

Every fit refreshes the aligner on the resident domain pair with a fresh
fused seed drawn from the run's seed, and ends in ``synchronize``: the time
a fitter waits for it.  Set-up makes the data, sigma and one warm fit.
"""
from __future__ import annotations

import random
import time

import numpy as np

from portbench.checks import fit_gaps, worst
from portbench.drivers.common import FITS, SAMPLE, Inputs, Reservoir, substream, sync
from portbench.references import rftca


class Loop:
    def __init__(self, cell, seed: int, device, program):
        cfg = cell.config
        if cfg["ensemble"] != 1:
            raise ValueError("the reference draws one Omega: ensemble must be 1")
        self.cfg, self.device, self.program = cfg, device, program
        self.inputs = Inputs(cfg, seed, device)
        self.seeds = random.Random(substream(seed, FITS))
        self.sample = Reservoir(cell.traffic["check_sample"], substream(seed, SAMPLE))
        self.times: list[float] = []
        self._fit(self.seeds.getrandbits(32))

    def _fit(self, fused_seed: int):
        out = self.program.fit(self.inputs.x_s, self.inputs.x_t, cfg=self.cfg,
                               sigma=self.inputs.sigma, fused_seed=fused_seed)
        sync(self.device)
        return out

    def step(self) -> None:
        fused_seed = self.seeds.getrandbits(32)
        t0 = time.perf_counter()
        out = self._fit(fused_seed)
        self.times.append(time.perf_counter() - t0)
        self.sample.offer((fused_seed, out[:4]))

    def drain(self) -> None:
        sync(self.device)

    def work(self) -> dict:
        return {"fits": len(self.times)}

    def attempted(self) -> int:
        return len(self.times)

    def end_to_end(self, window_s: float) -> dict:
        if not self.times:
            return {}
        return {"fit_ms": 1e3 * window_s / len(self.times),
                "fit_p95_ms": 1e3 * float(np.percentile(self.times, 95))}

    def check(self) -> dict:
        cfg, x = self.cfg, self.inputs
        gaps: dict = {}
        for fused_seed, (w, vals, g_h, u) in self.sample.items:
            ref_w, ref_vals, ref_g_h, ref_u = rftca.fit(
                x.x_s, x.x_t, n_features=cfg["n_features"], m=cfg["m"], gamma=cfg["gamma"],
                sigma=x.sigma, kernel=cfg["kernel"], fused_seed=fused_seed)
            worst(gaps, fit_gaps(w, vals, g_h, u, ref_vals=ref_vals, ref_g_h=ref_g_h,
                                 ref_u=ref_u, gamma=cfg["gamma"]))
        return gaps
