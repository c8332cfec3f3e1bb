"""CPU tests of a run: no card means no result; at a tiny size the program
comes out correct, and the control and each fault the cells can have come
out not correct.

The harness's look for a card is skipped by calling ``bench.run_cell`` with
``device="cpu"``, where the port runs its kernels' plain versions; the
limits are the cells' own.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import bench, spec
from portbench.program import PortProgram
from portbench.references.rftca import ControlProgram

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dim=48, n_source=260, n_target=140, n_features=32, m=4, sigma_subsample=96)
TINY_TRAFFIC = dict(trace_skip_seconds=0.05, trace_seconds=0.1)


def _tiny(name: str) -> spec.Cell:
    cell = spec.load_cell(ROOT, name)
    return dataclasses.replace(cell, config={**cell.config, **TINY},
                               traffic={**cell.traffic, **TINY_TRAFFIC})


def _run(name: str, program=None, trace: bool = False) -> dict:
    return bench.run_cell(_tiny(name), seed=2**31 + 17, seconds=0.25, trace=trace, device="cpu",
                          program=program)


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "a2w-fit", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", ["a2w-fit", "visda-fit", "visda-transform"])
def test_the_program_at_a_tiny_size_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == set(spec.load_cell(ROOT, name).end_to_end)
    assert list(r)[-1] == "checks"


def test_a_traced_run_reads_its_window():
    r = _run("a2w-fit", trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", ["a2w-fit", "visda-transform"])
def test_the_control_is_not_correct(name):
    r = _run(name, ControlProgram("tf32"))
    assert not r["correct"], r["checks"]


class Stale(PortProgram):
    """A step that returns its state unchanged: every call answers as the first."""

    def __init__(self):
        self.first_fit = self.first_f = None

    def fit(self, *a, **kw):
        if self.first_fit is None:
            self.first_fit = super().fit(*a, **kw)
        return self.first_fit

    def transform(self, state, x):
        if self.first_f is None:
            self.first_f = super().transform(state, x)
        return self.first_f


class Half(PortProgram):
    """Half of the batch left out, the means taken over the rest."""

    def fit(self, x_s, x_t, **kw):
        return super().fit(x_s[:, : x_s.shape[1] // 2].contiguous(),
                           x_t[:, : x_t.shape[1] // 2].contiguous(), **kw)

    def transform(self, state, x):
        half = super().transform(state, x[:, : x.shape[1] // 2 + 1].contiguous())
        return torch.cat([half, half], dim=1)[:, : x.shape[1]]


class Altered(PortProgram):
    """An answer altered where it is produced: one entry moved by 1 % of the largest."""

    def fit(self, *a, **kw):
        w, vals, g_h, u, state = super().fit(*a, **kw)
        w[0, 0] += 0.01 * w.abs().max()
        return w, vals, g_h, u, state

    def transform(self, state, x):
        f = super().transform(state, x)
        f[0, 0] += 0.01 * f.abs().max()
        return f


@pytest.mark.parametrize("fault", [Stale, Half, Altered])
@pytest.mark.parametrize("name", ["a2w-fit", "visda-transform"])
def test_each_fault_is_not_correct(name, fault):
    r = _run(name, fault())
    assert not r["correct"], r["checks"]
