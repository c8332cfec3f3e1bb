"""Finds a cell's parts by the names in ``BENCHMARK.json``.

- configuration ``<c>``: the file its entry names (``configs/<c>.json``);
- traffic ``<t>``: ``traffic/<t>.json``, whose ``driver`` names the loop in
  ``drivers/<driver>.py``;
- the limits of cell ``<w>``: ``limits/<w>.json``;
- per-layer metric ``<m>``: the reader ``metrics/<m>.py`` (its ``read``, and
  its ``LAYER`` where it reads one layer's kernels);
- layer ``<l>``: the kernel-name patterns of ``layers/<l>.json``.  A reader
  takes its own layer's kernels, whatever other layer claims them too; the
  cell's readers' layers, in ``BENCHMARK.json``'s order, only label the
  kernels of ``breakdown`` (the first that claims a kernel names it).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: dict[str, str]  # metric name: unit, the cell's own
    per_layer: dict[str, str]
    layers: dict[str, list[str]]  # the readers' layers: breakdown's labels


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise ValueError(f"no {what} named {name!r} in BENCHMARK.json")


def _listed(metrics: list[dict], cell: str) -> dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics if cell in m.get("workloads", [cell])}


def load_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    bench = _load(root / "BENCHMARK.json") if bench is None else bench
    w = _by_name(bench["workloads"], name, "workload")
    config = _load(root / _by_name(bench["configs"], w["config"], "configuration")["file"])
    traffic = _load(HERE / "traffic" / f"{w['traffic']}.json")
    per_layer = _listed(bench["per_layer"], name)
    layers: dict[str, list[str]] = {}
    for metric in per_layer:
        layer = getattr(_reader_module(metric), "LAYER", None)
        if layer is not None and layer not in layers:
            layers[layer] = layer_patterns(layer)
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=_listed(bench["end_to_end"], name), per_layer=per_layer,
                layers=layers)


def layer_patterns(layer: str) -> list[str]:
    return _load(HERE / "layers" / f"{layer}.json")["patterns"]


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}").Loop


def _reader_module(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    return _reader_module(metric).read
