#!/usr/bin/env python3
"""Time one family of the port's tensor-core kernels on one CUDA card, at
``chip_smoke.py``'s data, through the public entry points.

The data is ``chip_smoke.py``'s (``make_domains(seed=0)``, p = 2048, n =
3612, sigma by the median heuristic).  Families:

  seed_fused  the seed-fused featurize (K7, N = 4096) and streamed Gram (K5,
              N = 1000, S = 1) with Gaussian and Cauchy (``laplace``) draws.
              With Cauchy draws about half the phases reach |z| >= 64, where
              the featurize recomputes them as fp32's FMA chain.
  operand     the operand-Omega streamed Gram (K2 at N = 1000, one chunk; K3
              at N = 4096, two chunks; Omega from ``draw_omega``, and K2 also
              with a Cauchy Omega) and the centered Gram (K8 at 2N = 2000 and
              8192 on K1's Sigma), each beside one library call: ``torch.matmul``
              of the same products (Omega X and [cos; sin] [cos; sin]^T; the
              centered Sigma times its transpose).

It uses only the public entry points, so it runs against any checkout of the
port: run it from the root of two checkouts in one call to compare them on
one card.

    python3 scripts/time_kernels.py seed_fused
    python3 scripts/time_kernels.py operand

Prints one JSON object: milliseconds per call (CUDA events, after a warm-up
call) for each kernel and library call, and the card's name.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def seed_fused(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.kernels import rff
    from repro_torch.kernels import rff_gram_stream as gram

    for kind in ("gauss", "laplace"):
        kw = dict(n_features=4096, seed=cs.SEED, ensemble_index=1, sigma=sigma, rf_kernel=kind)
        out[f"K7_{kind}_ms"] = cs.cuda_ms(torch, lambda: rff.rff_fused(x, **kw), 5)
        kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma, rf_kernel=kind)
        out[f"K5_{kind}_ms"] = cs.cuda_ms(
            torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 3)


def operand(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import rff
    from repro_torch.kernels import centered_gram as centered
    from repro_torch.kernels import rff_gram_stream as gram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = x.device
    for key, nf in (("K2", 1000), ("K3", 4096)):
        om = draw_omega(cs.SEED, nf, cs.P, sigma=sigma, device=dev)
        out[f"{key}_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 5)
        z = om @ x
        w = torch.cat([torch.cos(z), torch.sin(z)])
        out[f"{key}_library_ms"] = cs.cuda_ms(
            torch, lambda: (torch.matmul(om, x), torch.matmul(w, w.T)), 5)
        del z, w
        sig = rff.rff(x, om)
        c = sig - sig.mean(dim=1, keepdim=True)
        out[f"K8_{2 * nf}_ms"] = cs.cuda_ms(torch, lambda: centered.centered_gram(sig), 5)
        out[f"K8_{2 * nf}_library_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(c, c.T), 5)
        del sig, c, om
    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, kernel="laplace", device=dev)
    out["K2_laplace_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=("seed_fused", "operand"))
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.kernels_math import ell_vector, median_sigma
    from repro_torch.data import make_domains
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.build_all()
    doms = make_domains(2, cs.N_S, dim=cs.P, seed=cs.SEED)
    x = torch.tensor(np.ascontiguousarray(np.concatenate([doms[0].x, doms[1].x[:, :cs.N_T]], 1)),
                     device=dev)
    ell = ell_vector(cs.N_S, cs.N_T, device=dev)
    sigma = median_sigma(x)
    out = {"device": torch.cuda.get_device_name(0), "root": str(ROOT), "family": args.family}
    {"seed_fused": seed_fused, "operand": operand}[args.family](cs, torch, x, ell, sigma, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
