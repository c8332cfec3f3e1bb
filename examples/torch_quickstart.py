"""Quickstart on the PyTorch port: RF-TCA (paper Algorithm 1) on a synthetic
domain-shift task.

    PYTHONPATH=src python examples/torch_quickstart.py               # the CUDA card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Fits the RFF-based transfer components between a source and a target domain,
trains a classifier on aligned source features, and compares target accuracy
against no adaptation — the paper's core single-machine claim, through
``repro_torch`` (``examples/quickstart.py`` is the same run on the JAX
reference).  On the card the fit's Gram and featurize passes are the
hand-written kernels.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.baselines import rf_tca_baseline, source_only, tca_baseline
from repro_torch.core.rf_tca import rf_tca
from repro_torch.data import make_domains, normalize_unit
from repro_torch.device import resolve_device


def run(args, device=None) -> dict:
    """The quickstart's numbers: the aligned features' shapes, the top
    eigenvalues, the message size and the three target accuracies."""
    dev = resolve_device(device if device is not None else args.device)
    doms = make_domains(2, 400, shift=1.2, seed=7)
    source, target = doms

    print("== RF-TCA quickstart (repro_torch) ==")
    print(f"source: X{source.x.shape}, target: X{target.x.shape}\n")

    # 1) low-level API: fit + transform (out-of-sample capable)
    f_s, f_t, state = rf_tca(
        normalize_unit(source.x), normalize_unit(target.x),
        n_features=512, m=16, gamma=1e-3, sigma=1.0, seed=0, device=dev,
    )
    eigvals = state.eigvals.cpu().numpy()
    print(f"aligned features: F_S {tuple(f_s.shape)}, F_T {tuple(f_t.shape)}")
    print(f"top eigenvalues: {np.round(eigvals[:4], 4)}")
    print(f"client message size (2N): {2 * state.omega.shape[0]} floats\n")

    # 2) end-to-end accuracy comparison
    acc_none = source_only([source], target, seed=0, device=dev)
    acc_tca = tca_baseline([source], target, gamma=1e-3, m=16, device=dev)
    acc_rf = rf_tca_baseline([source], target, n_features=512, gamma=1e-3, m=16, device=dev)
    print(f"target accuracy, no adaptation : {acc_none:.3f}")
    print(f"target accuracy, vanilla TCA   : {acc_tca:.3f}")
    print(f"target accuracy, RF-TCA        : {acc_rf:.3f}")
    return {"f_s_shape": tuple(f_s.shape), "f_t_shape": tuple(f_t.shape),
            "eigvals": eigvals, "message_floats": 2 * state.omega.shape[0],
            "acc_none": acc_none, "acc_tca": acc_tca, "acc_rf": acc_rf}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    out = run(parse(argv))
    assert out["acc_rf"] > out["acc_none"], "RF-TCA should beat source-only under shift"
    print("\nOK: RF-TCA recovers accuracy lost to domain shift.")


if __name__ == "__main__":
    main()
