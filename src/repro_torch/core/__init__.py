"""Core paper contribution: RFF, TCA variants, RF-TCA, decomposable MMD
(PyTorch port of ``repro.core``, re-exporting its 27 names).

One name is both a submodule and a function: ``repro_torch.core.rf_tca`` is
the module (``from repro_torch.core import rf_tca`` then reaches
``rf_tca.rf_tca_fit``), and calling it calls the function ``rf_tca.rf_tca``.
The reference's package binds the function over its submodule instead.
"""
import sys
import types

from repro_torch.core.kernels_math import (
    centering_matrix,
    ell_vector,
    gaussian_kernel,
    intrinsic_dim,
    laplace_kernel,
)
from repro_torch.core.mmd import message, mmd_projected, mmd_projected_multi, mmd_rff, mmd_rkhs
from repro_torch.core.rf_tca import (
    RFTCAState,
    rf_tca_fit,
    rf_tca_fit_with_stats,
    rf_tca_resolve,
    rf_tca_transform,
    solve_w_rf,
    solve_w_rf_cholesky,
    solve_w_rf_gram,
    streaming_gram,
)
from repro_torch.core.rff import draw_omega, rff_features, rff_features_rows, rff_message
from repro_torch.core.tca import TCAResult, r_tca, vanilla_tca


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return self.rf_tca(*args, **kwargs)


rf_tca = sys.modules[__name__ + ".rf_tca"]
rf_tca.__class__ = _CallableModule

__all__ = [
    "RFTCAState", "TCAResult", "centering_matrix", "draw_omega", "ell_vector", "gaussian_kernel",
    "intrinsic_dim", "laplace_kernel", "message", "mmd_projected", "mmd_projected_multi",
    "mmd_rff", "mmd_rkhs", "r_tca", "rf_tca", "rf_tca_fit", "rf_tca_fit_with_stats",
    "rf_tca_resolve", "rf_tca_transform", "rff_features", "rff_features_rows", "rff_message",
    "solve_w_rf", "solve_w_rf_cholesky", "solve_w_rf_gram", "streaming_gram", "vanilla_tca",
]
