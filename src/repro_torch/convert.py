"""Carry a reference ``RFTCAState`` (and its fit statistics) into the port.

The reference's state fields arrive as numpy arrays (or ``None`` and plain
tuples); nothing of the reference package is imported here.  With these, a
state fitted by ``repro`` transforms and re-solves in ``repro_torch``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.rf_tca import RFTCAState
from repro_torch.device import as_f32, resolve_device


def state_from_reference(omega, w_rf, eigvals, fused, *, device=None) -> RFTCAState:
    """The port's :class:`RFTCAState` from a reference state's fields.

    ``omega`` is ``None`` on the seed-fused path; ``fused`` is the reference's
    ``(seed, ensemble, sigma, kernel)`` spec or ``None``.
    """
    dev = resolve_device(device)
    spec = None
    if fused is not None:
        seed, ensemble, sigma, kernel = fused
        spec = (int(seed), int(ensemble), float(sigma), str(kernel))
    return RFTCAState(
        omega=None if omega is None else as_f32(np.asarray(omega), dev),
        w_rf=as_f32(np.asarray(w_rf), dev),
        eigvals=as_f32(np.asarray(eigvals), dev),
        fused=spec,
    )


def stats_from_reference(stats: dict, *, device=None) -> dict:
    """The retained statistics of ``rf_tca_fit_with_stats`` (``gram`` = G_H,
    ``u``, and the solve's ``gamma``, ``m``, ``solver``, ``seed``) on the
    port's device, ready for ``repro_torch.core.rf_tca.rf_tca_resolve``."""
    dev = resolve_device(device)
    return {
        "gram": as_f32(np.asarray(stats["gram"]), dev),
        "u": as_f32(np.asarray(stats["u"]), dev),
        "gamma": float(stats["gamma"]),
        "m": int(stats["m"]),
        "solver": str(stats["solver"]),
        "seed": int(stats["seed"]),
    }
