"""Dry run: the real step of every (arch x input-shape) on ``meta`` tensors.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step on 512 forced host devices and reads XLA's memory and cost analyses.
The port runs the step itself, ``launch.train.build_train_step`` (AdamW and
clipping) for ``train_4k``, ``LM.prefill`` for ``prefill_32k`` and
``LM.decode_step`` for the decode shapes, at the shapes of
``repro_torch.configs.INPUT_SHAPES``, on parameters, optimizer state,
batches and caches that live on the ``meta`` device
(``LM.abstract``, ``specs.input_specs``, ``LM.abstract_cache``): every
operation runs its shape logic and nothing is allocated or computed.
``roofline.count_step`` counts the step as it runs (products, bytes, the
hand-written kernels' reported work, collectives) and the peak of the
storages it creates.

The ``memory`` block: ``argument_bytes`` sums the step's inputs (parameters,
optimizer state, batch, cache); ``output_bytes`` its outputs;
``temp_bytes`` the peak of the live storages the step created, less its
outputs; ``alias_bytes`` the outputs that are the inputs' own storages (a
decode step writes its cache in place).

The port's ``LM`` has no tensor parallelism, so it has no counterpart of
the per-chip numbers that XLA's SPMD partitioner gives the reference on a
(16, 16) mesh: ``--mesh`` takes ``card`` (one H100, a 1 x 1 mesh) and raises
for ``single`` and ``multi`` (ROADMAP: LM tensor and data parallelism over
NCCL ranks).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import input_specs
from repro_torch.launch.train import build_train_step
from repro_torch.models import LM
from repro_torch.optim import adamw
from repro_torch.utils.tree import tree_leaves

MESHES = ("card", "single", "multi")


def active_params(model: LM) -> int:
    cfg = model.cfg
    total = model.param_count()
    if not cfg.n_experts:
        return total
    routed = cfg.n_layers * 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
    return int(total - routed + routed * cfg.top_k / cfg.n_experts)


def adjusted_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k needs sub-quadratic attention: SSM/hybrid run natively; all
    attention archs get a 4096-token sliding window (ring-buffer cache)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return dataclasses.replace(cfg, attn_window=4096)
    return cfg


def check_mesh(mesh: str) -> None:
    if mesh not in MESHES:
        raise ValueError(f"--mesh {mesh!r}: one of {MESHES}")
    if mesh != "card":
        raise ValueError(
            f"--mesh {mesh}: the port's LM has no tensor or data parallelism yet, so it has no "
            f"per-card counterpart of the reference's SPMD-partitioned (16, 16) step (ROADMAP: "
            f"LM tensor and data parallelism over NCCL ranks); use --mesh card")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def step_of(model: LM, shape: InputShape):
    """(fn, args) of the real step at ``shape`` on ``meta`` tensors."""
    cfg = model.cfg
    params = model.abstract()
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        # launch.train's client count on one card: max(2, its data axis of 1)
        n_clients = 2 if shape.global_batch % 2 == 0 else 1
        opt = adamw(3e-4, weight_decay=0.1)
        return build_train_step(model, opt, n_clients), (params, opt.init(params), batch)
    if shape.kind == "prefill":
        return torch.no_grad()(model.prefill), (params, batch)
    cache = model.abstract_cache(shape.global_batch, shape.seq_len)

    def serve_step(params, cache, batch):
        return model.decode_step(params, cache, batch, shape.seq_len - 1)

    return torch.no_grad()(serve_step), (params, cache, batch)


def lower_combo(arch: str, shape_name: str, mesh: str = "card", depth: int | None = None,
                opt: bool = False):
    """Returns (record dict, StepCount) for one (arch, shape) on one card:
    the record has the reference's keys but its compile and lower times (the
    count also holds each kernel's reported calls and the operations run).

    The port's layer loop is always unrolled, so the reference's ``unroll``
    has no counterpart; ``opt`` sets the reference's §Perf switches, of which only ``sharded_ce``
    (the same numbers) and ``moe_ep`` (with no mesh, nothing) reach the
    port."""
    check_mesh(mesh)
    shape = INPUT_SHAPES[shape_name]
    cfg = adjusted_config(get_config(arch), shape)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if opt:
        cfg = dataclasses.replace(cfg, sharded_ce=True, moe_ep=True, causal_skip=True,
                                  seq_parallel=True)
    model = LM(cfg)
    fn, args = step_of(model, shape)
    out, count = rl.count_step(fn, *args)
    roof = rl.from_count(count)
    n_active = active_params(model)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = rl.model_flops(n_active, n_tokens, shape.kind)
    out_bytes = _nbytes(out)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh,
        "n_chips": 1,
        "kind": shape.kind,
        "params_total": model.param_count(),
        "params_active": n_active,
        "memory": {
            "argument_bytes": _nbytes(args),
            "output_bytes": out_bytes,
            "temp_bytes": max(0, count.peak_bytes - (out_bytes - count.alias_bytes)),
            "alias_bytes": count.alias_bytes,
        },
        "roofline": roof.as_dict(),
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / roof.flops_per_chip) if roof.flops_per_chip else 0.0,
    }
    return record, count


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card", choices=list(MESHES))
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted: the port's layer loop is always unrolled")
    args = ap.parse_args(argv)
    check_mesh(args.mesh)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)

    failures, records = [], []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}_{args.mesh}" + ("_unroll" if args.unroll else "")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {tag}")
                continue
            try:
                t0 = time.time()
                rec, count = lower_combo(arch, shape, args.mesh)
                run_s = time.time() - t0
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                r = rec["roofline"]
                print(
                    f"[ok]   {tag}: run={run_s:.2f}s ops={count.ops} "
                    f"flops={r['flops_per_chip']:.3g} "
                    f"bytes={r['hbm_bytes_per_chip']:.3g} "
                    f"coll={r['coll_bytes_per_chip']:.3g} "
                    f"dominant={r['dominant']} "
                    f"useful={rec['useful_flops_ratio']:.2f}"
                )
            except Exception as e:  # noqa: BLE001 — report all failures at end
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run combos failed: {[t for t, _ in failures]}")
    print("all requested combos ran on meta tensors")
    return records


if __name__ == "__main__":
    main()
