"""Roofline sweep: per-step FLOPs, bytes and collective bytes for every
(arch x input-shape), per card of the (16, 16) production mesh.

Port of ``repro.launch.roofline_sweep``.  The reference compiles each combo
unrolled at two reduced depths and extrapolates every cost term linearly in
depth, because XLA counts a scanned layer once and fully unrolled stacks do
not compile.  The port's counter sees every operation of a meta-tensor run
(``launch.dryrun``), so a full-depth run is exact (``--exact``); the
two-depth linear extrapolation is kept as the default, cheap mode, exact for
uniform stacks and within the reference's stated 2% for grouped ones.  The
step is rank 0's of the "16x16" mesh, as the reference's sweep compiles it
(``launch.dryrun --mesh single``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --arch zamba2-7b \\
      --shape train_4k --exact
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import active_params, adjusted_config, lower_combo
from repro_torch.models import LM


def probe_depths(arch: str) -> tuple[int, int]:
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        u = cfg.attn_every
        return u + 1, 2 * (u + 1)  # pattern: k*(u ssm + shared attn) + k extra ssm
    if cfg.family == "vlm":
        u = cfg.cross_attn_every + 1
        return u, 2 * u
    return 2, 4


def sweep_combo(arch: str, shape_name: str, opt: bool = False, *, probe: bool = True) -> dict:
    """The roofline at full depth: extrapolated linearly from the two probe
    depths (``probe=True``, the reference's method) or counted on a
    full-depth meta run (``probe=False``, exact), per card of the 16x16
    mesh."""
    cfg_full = get_config(arch)
    l1, l2 = probe_depths(arch)
    if probe:
        recs = [lower_combo(arch, shape_name, "single", depth=depth, opt=opt)[0]
                for depth in (l1, l2)]

        def extrapolate(a, b):
            return a + (b - a) / (l2 - l1) * (cfg_full.n_layers - l1)

        def term(key):
            return extrapolate(recs[0]["roofline"][key], recs[1]["roofline"][key])

        coll_kinds = {
            kind: max(0.0, extrapolate(recs[0]["roofline"]["coll_by_kind"][kind],
                                       recs[1]["roofline"]["coll_by_kind"][kind]))
            for kind in recs[0]["roofline"]["coll_by_kind"]}
        roof = rl.Roofline(
            flops_per_chip=max(0.0, term("flops_per_chip")),
            hbm_bytes_per_chip=max(0.0, term("hbm_bytes_per_chip")),
            coll_bytes_per_chip=max(0.0, term("coll_bytes_per_chip")),
            coll_by_kind=coll_kinds,
        )
    else:
        recs = [lower_combo(arch, shape_name, "single", opt=opt)[0]]
        r = recs[0]["roofline"]
        roof = rl.Roofline(r["flops_per_chip"], r["hbm_bytes_per_chip"],
                           r["coll_bytes_per_chip"], dict(r["coll_by_kind"]))
    shape = INPUT_SHAPES[shape_name]
    # params / model flops at FULL depth (the probes carry reduced-depth counts)
    model = LM(adjusted_config(cfg_full, shape))
    n_active = active_params(model)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = rl.model_flops(n_active, n_tokens, shape.kind)
    flops_global = roof.flops_per_chip * recs[0]["n_chips"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": recs[0]["mesh"],
        "kind": shape.kind,
        "probe_depths": [l1, l2] if probe else [],
        "full_depth": cfg_full.n_layers,
        "params_total": model.param_count(),
        "params_active": n_active,
        "roofline": roof.as_dict(),
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / flops_global) if flops_global else 0.0,
        "probe_records": recs,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/roofline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true", help="the reference's §Perf switches")
    ap.add_argument("--exact", action="store_true",
                    help="count a full-depth run (default: extrapolate from two probe depths)")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures, records = [], []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}" + ("_opt" if args.opt else "")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {tag}")
                continue
            try:
                rec = sweep_combo(arch, shape, opt=args.opt, probe=not args.exact)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                r = rec["roofline"]
                print(
                    f"[ok]   {tag}: compute={r['compute_s']*1e3:.2f}ms "
                    f"memory={r['memory_s']*1e3:.2f}ms coll={r['collective_s']*1e3:.2f}ms "
                    f"dominant={r['dominant']} useful={rec['useful_flops_ratio']:.2f}"
                )
            except Exception as e:  # noqa: BLE001
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}")
    if failures:
        raise SystemExit(f"{len(failures)} roofline combos failed")
    print("roofline sweep complete")
    return records


if __name__ == "__main__":
    main()
