"""The system under test: the port's RF-TCA entry points, the one module of
the benchmark that imports ``repro_torch``.

``fit`` is the seed-fused fit that ``serve.AlignerServer`` runs
(``rf_tca_fit_with_stats`` with ``w_rf="fused:<seed>"``); ``transform`` is
``rf_tca_transform``.  The reference's control
(``references.rftca.ControlProgram``) and the faults of the tests take the
same interface.
"""
from __future__ import annotations

import torch

from repro_torch.core.rf_tca import rf_tca_fit_with_stats, rf_tca_transform


class PortProgram:
    def fit(self, x_s: torch.Tensor, x_t: torch.Tensor, *, cfg: dict, sigma: float,
            fused_seed: int):
        """(W_RF, eigenvalues, G_H, u, state) of one fit."""
        state, stats = rf_tca_fit_with_stats(
            x_s, x_t, n_features=cfg["n_features"], m=cfg["m"], gamma=cfg["gamma"], sigma=sigma,
            kernel=cfg["kernel"], solver=cfg["solver"], w_rf=f"fused:{fused_seed}",
            ensemble=cfg["ensemble"], device=x_s.device,
        )
        return state.w_rf, state.eigvals, stats["gram"], stats["u"], state

    def transform(self, state, x: torch.Tensor) -> torch.Tensor:
        return rf_tca_transform(state, x)
