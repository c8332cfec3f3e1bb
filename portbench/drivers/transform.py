"""Closed loop of bulk transforms by one deployed aligner.

Set-up fits the aligner once.  One pass maps the traffic's ``domains`` of the
pair, already on the device, in turn, each cut into contiguous batches of
``batch`` columns in order (the last one holding the rest; ``null``: the set
whole, one call).  Every seed has the same batches; the seed sets the data and
the fit.  The window makes pass after pass, each call dispatched without
waiting and each pass ending in ``synchronize``.  The check holds the set-up
fit to the reference (the transform's input state) and a sample of each
batch's outputs (``check_sample`` a batch) to W_RF^T Sigma_ref(X), W_RF the
fit's: the reference follows the program's state for the projection, after
judging that state on its own.
"""
from __future__ import annotations

import random

from portbench.checks import fit_gaps, rel_gap
from portbench.drivers.common import FITS, SAMPLE, Inputs, Reservoir, substream, sync
from portbench.references import rftca


def pass_bounds(n: int, batch: int) -> list[tuple[int, int]]:
    """The (first, end) columns of one pass's batches over ``n`` columns."""
    return [(c0, min(c0 + batch, n)) for c0 in range(0, n, batch)]


class Loop:
    def __init__(self, cell, seed: int, device, program):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.device, self.program = cfg, device, program
        self.inputs = Inputs(cfg, seed, device)
        self.fit_seed = random.Random(substream(seed, FITS)).getrandbits(32)
        self.fit_out = program.fit(self.inputs.x_s, self.inputs.x_t, cfg=cfg,
                                   sigma=self.inputs.sigma, fused_seed=self.fit_seed)
        self.state = self.fit_out[4]
        sets = {"source": self.inputs.x_s, "target": self.inputs.x_t}
        self.batches = [x[:, c0:c1].contiguous()
                        for x in (sets[d] for d in tr["domains"])
                        for c0, c1 in pass_bounds(x.shape[1], tr["batch"] or x.shape[1])]
        for xb in {xb.shape[1]: xb for xb in self.batches}.values():  # each width once
            program.transform(self.state, xb)
        sync(device)
        self.samples = [Reservoir(tr["check_sample"], substream(seed, SAMPLE) + k)
                        for k in range(len(self.batches))]
        self.calls = self.cols = 0

    def step(self) -> None:
        k = self.calls % len(self.batches)
        xb = self.batches[k]
        f = self.program.transform(self.state, xb)
        self.calls += 1
        self.cols += xb.shape[1]
        self.samples[k].offer(f)
        if k == len(self.batches) - 1:
            sync(self.device)

    def drain(self) -> None:
        sync(self.device)

    def work(self) -> dict:
        return {"columns": self.cols, "calls": self.calls}

    def attempted(self) -> int:
        return self.calls

    def end_to_end(self, window_s: float) -> dict:
        return {"transform_cols_s": self.cols / window_s} if self.cols else {}

    def check(self) -> dict:
        cfg, x = self.cfg, self.inputs
        self.state = None
        w, vals, g_h, u = self.fit_out[:4]
        ref_w, ref_vals, ref_g_h, ref_u = rftca.fit(
            x.x_s, x.x_t, n_features=cfg["n_features"], m=cfg["m"], gamma=cfg["gamma"],
            sigma=x.sigma, kernel=cfg["kernel"], fused_seed=self.fit_seed)
        gaps = fit_gaps(w, vals, g_h, u, ref_vals=ref_vals, ref_g_h=ref_g_h, ref_u=ref_u,
                        gamma=cfg["gamma"])
        om = rftca.omega(self.fit_seed, cfg["n_features"], cfg["dim"], sigma=x.sigma,
                         kernel=cfg["kernel"], device=x.x_t.device)
        gaps["f_gap"] = max((rel_gap(f, rftca.transform(w, xb, om))
                             for xb, sample in zip(self.batches, self.samples)
                             for f in sample.items), default=float("inf"))
        return gaps
