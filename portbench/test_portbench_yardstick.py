"""CPU tests of the benchmark's yardstick: counts, the frozen Omega law, the
data generator, the imports, and BENCHMARK.json against its files."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from portbench import counts, datagen, spec
from portbench.references import rftca
from repro_torch.kernels import prng

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _cfg(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, stats_flops, stats_least_ms, stats_bytes_ms, fit_flops", [
    ("rftca-office31-a2w", 2.926e10, 0.0591, 0.0136, 2.952e10),
    ("rftca-visda17", 1.6835e12, 3.401, 0.513, 1.6837e12),
])
def test_counts_at_the_configurations(name, stats_flops, stats_least_ms, stats_bytes_ms,
                                      fit_flops):
    c = counts.for_config(_cfg(name))
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert c["stats_flops"] == pytest.approx(stats_flops, rel=5e-4)
    assert c["fit_flops"] == pytest.approx(fit_flops, rel=5e-4)
    least = counts.least_seconds(c["stats_flops"], c["stats_bytes"], peak)
    assert 1e3 * least == pytest.approx(stats_least_ms, rel=5e-4)
    assert 1e3 * c["stats_bytes"] / peak["bytes_s"] == pytest.approx(stats_bytes_ms, rel=5e-3)


def test_transform_counts_a_column():
    c = counts.for_config(_cfg("rftca-visda17"))
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert c["featurize_flops_per_col"] / peak["flops"] == pytest.approx(8.27e-9, rel=1e-3)
    assert c["featurize_bytes_per_col"] / peak["bytes_s"] == pytest.approx(4.83e-9, rel=1e-3)
    assert c["transform_flops_per_col"] == 2 * 1000 * 2048 + 4 * 1000 * 32


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**32 + 11])
def test_frozen_threefry_equals_the_ports_plain_bits(seed):
    for draw in (0, 1):
        ref = rftca.threefry_bits(seed, 19, 37, draw=draw)
        port = prng.threefry_bits_plain(seed, 19, 37, ensemble_index=draw, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(ref, port))


@pytest.mark.parametrize("kernel, sigma", [("gauss", 1.0), ("gauss", 27.3), ("laplace", 3.5)])
def test_frozen_omega_equals_the_ports_plain_draw(kernel, sigma):
    ref = rftca.omega(12345, 33, 70, sigma=sigma, kernel=kernel)
    port = prng.fused_omega_block_plain(12345, 33, 70, sigma=sigma, rf_kernel=kernel,
                                        device="cpu")
    assert ref.dtype == torch.float32
    assert torch.equal(ref, port)


def _pair(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return datagen.domain_pair(dim=24, n_source=50, n_target=30, n_classes=3, shift=0.8,
                               class_sep=3.0, noise=0.6, generator=gen, device="cpu")


def test_data_is_a_function_of_the_seed():
    a, b, c = _pair(5), _pair(5), _pair(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (24, 50) and a[1].shape == (24, 30)
    assert a[0].dtype == torch.float32 and a[0].is_contiguous()
    s1 = datagen.median_sigma(*a, subsample=40, generator=torch.Generator().manual_seed(1))
    s2 = datagen.median_sigma(*b, subsample=40, generator=torch.Generator().manual_seed(1))
    assert s1 == s2 and s1 > 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0, 1.0 + 2**-12])
    assert rftca.tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0, 1.0]


def _top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _top_imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
    for f in sorted((HERE / "references").glob("*.py")):
        assert _top_imports(f) <= {"__future__", "math", "numpy", "torch"}, f


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"], bench)
        assert len(cell.end_to_end) >= 2 and cell.per_layer and cell.limits
        for m in bench["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] in cell.end_to_end
        spec.driver(cell.traffic["driver"])
        for name in cell.per_layer:
            assert callable(spec.reader(name))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert 1 <= bench["run_seconds"] <= 51
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_a_pass_covers_the_target_set_in_order():
    from portbench.drivers.transform import pass_bounds

    b = pass_bounds(55388, 256)
    assert len(b) == 217 and b[0] == (0, 256) and b[-1] == (55296, 55388)
    assert all(e == s2 for (_, e), (s2, _) in zip(b, b[1:]))
    assert {e - s for s, e in b[:-1]} == {256}
    assert pass_bounds(512, 256) == [(0, 256), (256, 512)]


class _Ev:
    """A profiler event as ``TraceView.from_events`` reads it."""

    def __init__(self, name, start, end, device=False, thread=1):
        self.name, self.thread = name, thread
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_trace_view_counts_overlap_once_and_names_idle_gaps():
    from portbench.profiling import WINDOW, TraceView

    events = [
        _Ev(WINDOW, 0.0, 100.0), _Ev(WINDOW, 0.0, 100.0, device=True),
        _Ev("aten::linalg_eigh", 40.0, 70.0), _Ev("cudaMemcpyAsync", 45.0, 65.0),
        _Ev("aten::mm", 80.0, 85.0, thread=2),
        _Ev("featurize_tf32_kernel", 10.0, 30.0, device=True),
        _Ev("gram_tf32_kernel", 20.0, 40.0, device=True),
        _Ev("sytrd4_gpu", 70.0, 90.0, device=True),
    ]
    layers = {"stats": ["featurize_tf32", "gram_tf32"], "solve": ["sytrd"]}
    t = TraceView.from_events(events, layers)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(50e-6)
    assert t.layer_seconds("stats") == pytest.approx(40e-6)
    assert t.layer_seconds("solve") == pytest.approx(20e-6)
    assert t.gaps() == [(0.0, 10.0), (40.0, 70.0), (90.0, 100.0)]
    b = t.breakdown()
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"host": 20e-6, "aten::linalg_eigh > cudaMemcpyAsync": 30e-6})
    assert b["device_ops"][0][0].startswith("stats: ")


def test_each_layer_takes_the_kernels_its_own_file_claims():
    from portbench.profiling import WINDOW, TraceView

    assert list(spec.load_cell(ROOT, "visda-fit").layers) == ["stats", "solve"]
    assert list(spec.load_cell(ROOT, "visda-transform").layers) == ["featurize"]
    events = [
        _Ev(WINDOW, 0.0, 100.0),
        _Ev("sytrd4_gpu", 0.0, 10.0, device=True),
        _Ev("ampere_sgemm_128x64_nn", 20.0, 30.0, device=True),
        _Ev("featurize_tf32_kernel", 40.0, 60.0, device=True),
    ]
    t = TraceView.from_events(events, {"stats": spec.layer_patterns("stats")})
    assert t.layer_seconds("solve") == pytest.approx(20e-6)
    assert t.layer_seconds("stats") == pytest.approx(20e-6)
    assert t.layer_seconds("featurize") == pytest.approx(20e-6)
    labels = {k.split(": ")[0] for k, _ in t.breakdown()["device_ops"]}
    assert labels == {"stats", "other"}
