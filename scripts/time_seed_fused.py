#!/usr/bin/env python3
"""Time the seed-fused featurize (K7) and streamed Gram (K5) with Gaussian
and Cauchy (``laplace``) draws on one CUDA card, at ``chip_smoke.py``'s data.

The data is ``chip_smoke.py``'s (``make_domains(seed=0)``, p = 2048, n =
3612, sigma by the median heuristic); K7 runs at N = 4096, K5 at N = 1000,
S = 1.  With Cauchy draws the phases are heavy-tailed and about half reach
|z| >= 64, where the featurize recomputes them as fp32's FMA chain, so this
times that path against the Gaussian one.  It uses only the public entry
points, so it runs against any checkout of the port: run it from the root
of two checkouts in one call to compare them on one card.

    python3 scripts/time_seed_fused.py

Prints one JSON object: milliseconds per call (CUDA events, after a warm-up
call) for each kernel and draw kind, and the card's name.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.kernels_math import ell_vector, median_sigma
    from repro_torch.data import make_domains
    from repro_torch.kernels import _build, rff
    from repro_torch.kernels import rff_gram_stream as gram

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
    out = {"device": torch.cuda.get_device_name(0), "root": str(ROOT)}
    for kind in ("gauss", "laplace"):
        kw = dict(n_features=4096, seed=cs.SEED, ensemble_index=1, sigma=sigma, rf_kernel=kind)
        out[f"K7_{kind}_ms"] = cs.cuda_ms(torch, lambda: rff.rff_fused(x, **kw), 5)
        kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma, rf_kernel=kind)
        out[f"K5_{kind}_ms"] = cs.cuda_ms(
            torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
