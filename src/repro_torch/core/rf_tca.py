"""RF-TCA (paper Algorithm 1, Section III): the seed-fused fit and transform.

Port of ``repro.core.rf_tca``.  Finds W_RF in R^{2N x m} as the top-m
solutions of the symmetric definite generalized eigenproblem

    G_H w = lambda (gamma I + u u^T) w,     G_H = Sigma H Sigma^T,  u = Sigma l,

from statistics streamed without ever materializing Sigma.  In this port:

- **Statistics pass**: the seed-fused stream only (``w_rf="fused:<seed>"``):
  W_RF's frequency rows are drawn inside the CUDA kernel from the
  counter-based threefry stream, S draws averaged (``ensemble=S``).
- **Solve**: Sherman–Morrison whitening B^{-1/2} = gamma^{-1/2}(I + c uhat
  uhat^T), then the top m eigenpairs of C = B^{-1/2} G_H B^{-1/2} by
  ``torch.linalg.eigh`` (the reference also leaves this to a library).
- **Transform**: W_RF^T Sigma(X) with draw 0's Omega materialized once per
  spec by the memo (:func:`fused_transform_omega`) and Sigma from the K1
  kernel.

Not yet ported, each raising ``NotImplementedError``: the omega-operand fit
(``w_rf=None``, kernels K2/K3), ``mode="dense"`` (K8) and the ``"lobpcg"``
and ``"cholesky"`` solvers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.kernels_math import ell_vector
from repro_torch.core.rff import rff_features
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.prng import fused_omega


class RFTCAState(NamedTuple):
    omega: torch.Tensor | None  # (N, p) frequency matrix; None on the fused path
    w_rf: torch.Tensor  # (2N, m) aligner
    eigvals: torch.Tensor  # (m,)
    # seed-fused spec (seed, ensemble, sigma, kernel) when omega is None: the
    # frequency matrix is a pure function of these and is re-drawn on demand
    fused: tuple | None = None


_OMEGA_OPERAND = "ROADMAP.md queue 1 step 2 (omega-operand stream fit, kernels K2/K3)"
_DENSE = "ROADMAP.md queue 1 step 2 (mode='dense', kernel K8)"
_SOLVERS = "ROADMAP.md queue 1 step 2 (solvers 'lobpcg' and 'cholesky')"


# --------------------------------------------------------------------------
# statistics pass
# --------------------------------------------------------------------------


def fused_streaming_gram(x: torch.Tensor, ell: torch.Tensor, *, n_features: int, seed: int,
                         ensemble: int = 1, sigma: float = 1.0,
                         rf_kernel: str = "gauss") -> tuple[torch.Tensor, torch.Tensor]:
    """Seed-fused (G_H (2N, 2N), u (2N,)) — no omega operand anywhere.

    CUDA tensors go through the fused Gram kernel, CPU tensors through its
    plain version (``kernels.rff_gram_stream``).
    """
    return ops.rff_gram_stream_fused(
        x, ell, n_features=n_features, seed=seed, ensemble=ensemble, sigma_rf=sigma,
        rf_kernel=rf_kernel,
    )


# --------------------------------------------------------------------------
# solve: top-m of  G_H w = lambda (gamma I + u u^T) w
# --------------------------------------------------------------------------


def _whiten_half(u: torch.Tensor, gamma: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Closed-form B^{-1/2} for B = gamma I + u u^T (identity plus rank one):
    B^{-1/2} = gamma^{-1/2} (I + c uhat uhat^T), c = sqrt(gamma/(gamma+|u|^2)) - 1.
    Applies to a (2N, k) block with two rank-one updates."""
    uu = u @ u
    c = torch.sqrt(gamma / (gamma + uu)) - 1.0
    uhat = u * torch.rsqrt(uu + 1e-30)
    inv_sqrt_gamma = torch.rsqrt(torch.tensor(gamma, dtype=u.dtype, device=u.device))

    def apply(v: torch.Tensor) -> torch.Tensor:
        return (v + c * torch.outer(uhat, uhat @ v)) * inv_sqrt_gamma

    return apply


def _whitened_cmat(g_h: torch.Tensor, u: torch.Tensor, gamma: float) -> torch.Tensor:
    """C = B^{-1/2} G_H B^{-1/2} via two rank-one whitening passes."""
    bihalf = _whiten_half(u, gamma)
    cmat = bihalf(bihalf(g_h).T)
    return 0.5 * (cmat + cmat.T)


def _top_eigh(cmat: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m (vals descending, vecs) of a symmetric matrix."""
    vals, vecs = torch.linalg.eigh(cmat)
    return vals.flip(0)[:m], vecs.flip(1)[:, :m]


def _apply_whiten(u: torch.Tensor, gamma: float, vecs: torch.Tensor) -> torch.Tensor:
    """w = B^{-1/2} vecs (the final back-transform)."""
    return _whiten_half(u, gamma)(vecs)


def solve_w_rf_gram(g_h: torch.Tensor, u: torch.Tensor, gamma: float, m: int, *,
                    solver: str = "eigh") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m solution of (7) from the streamed statistics (G_H, u).

    Returns (w_rf (2N, m), eigvals (m,)).
    """
    if solver in ("lobpcg", "cholesky"):
        raise NotImplementedError(f"solver={solver!r} is not ported yet: {_SOLVERS}")
    if solver != "eigh":
        raise ValueError(f"unknown solver {solver!r}")
    vals, vecs = _top_eigh(_whitened_cmat(g_h, u, gamma), m)
    return _apply_whiten(u, gamma, vecs), vals


# --------------------------------------------------------------------------
# public fit / transform
# --------------------------------------------------------------------------


def _parse_fused_spec(w_rf) -> int | None:
    """``w_rf="fused:<seed>"`` -> seed; None passes through; else error."""
    if w_rf is None:
        return None
    if isinstance(w_rf, str) and w_rf.startswith("fused:"):
        return int(w_rf.split(":", 1)[1])
    raise ValueError(f'w_rf must be None or "fused:<seed>", got {w_rf!r}')


def _fit_fused(x_s, x_t, *, n_features: int, m: int, gamma: float, sigma: float, kernel: str,
               solver: str, fused_seed: int, ensemble: int,
               device: torch.device) -> tuple[RFTCAState, dict]:
    """Seed-fused statistics pass and solve, returning the fitted state *and*
    the (G_H, u) statistics it solved from (the moment-space refresh input)."""
    x_s = as_f32(x_s, device)
    x_t = as_f32(x_t, device)
    x = torch.cat([x_s, x_t], dim=1).contiguous()
    ell = ell_vector(x_s.shape[1], x_t.shape[1], device=device)
    g_h, u = fused_streaming_gram(
        x, ell, n_features=n_features, seed=fused_seed, ensemble=ensemble, sigma=sigma,
        rf_kernel=kernel,
    )
    w, vals = solve_w_rf_gram(g_h, u, gamma, m, solver=solver)
    state = RFTCAState(omega=None, w_rf=w, eigvals=vals,
                       fused=(fused_seed, ensemble, sigma, kernel))
    stats = {"gram": g_h, "u": u, "gamma": float(gamma), "m": int(m), "solver": str(solver)}
    return state, stats


def _check_fit_args(mode: str, solver: str, w_rf, ensemble: int) -> int:
    if mode not in ("stream", "dense"):
        raise ValueError(f"unknown mode {mode!r}")
    if solver not in ("eigh", "lobpcg", "cholesky"):
        raise ValueError(f"unknown solver {solver!r}")
    if mode == "stream" and solver == "cholesky":
        raise ValueError(
            'solver="cholesky" factorizes the explicit-Sigma path and requires '
            'mode="dense"; the streaming solvers are "eigh" and "lobpcg"'
        )
    fused_seed = _parse_fused_spec(w_rf)
    if ensemble != 1 and fused_seed is None:
        raise ValueError('ensemble > 1 requires w_rf="fused:<seed>"')
    if fused_seed is not None and mode != "stream":
        raise ValueError('w_rf="fused:<seed>" requires mode="stream"')
    if mode == "dense":
        raise NotImplementedError(f"mode='dense' is not ported yet: {_DENSE}")
    if fused_seed is None:
        raise NotImplementedError(f"w_rf=None is not ported yet: {_OMEGA_OPERAND}")
    if solver != "eigh":
        raise NotImplementedError(f"solver={solver!r} is not ported yet: {_SOLVERS}")
    return fused_seed


def rf_tca_fit_with_stats(x_s, x_t, *, n_features: int, m: int, gamma: float = 1.0,
                          sigma: float = 1.0, kernel: str = "gauss", solver: str = "eigh",
                          w_rf: str | None = None, ensemble: int = 1,
                          device=None) -> tuple[RFTCAState, dict]:
    """Seed-fused :func:`rf_tca_fit` that also returns the fit statistics
    ``{"gram", "u", "gamma", "m", "solver"}`` — everything
    :func:`rf_tca_resolve` needs to re-solve W_RF from updated moments."""
    if _parse_fused_spec(w_rf) is None:
        raise ValueError(
            'rf_tca_fit_with_stats requires the seed-fused path: pass w_rf="fused:<seed>"'
        )
    fused_seed = _check_fit_args("stream", solver, w_rf, ensemble)
    return _fit_fused(
        x_s, x_t, n_features=n_features, m=m, gamma=gamma, sigma=sigma, kernel=kernel,
        solver=solver, fused_seed=fused_seed, ensemble=ensemble,
        device=resolve_device(device),
    )


def rf_tca_resolve(gram: torch.Tensor, u: torch.Tensor, *, gamma: float, m: int,
                   solver: str = "eigh", fused_spec: tuple) -> RFTCAState:
    """Re-solve W_RF from statistics alone (no data pass); ``fused_spec`` is
    the ``(seed, ensemble, sigma, kernel)`` of the original fit, so transforms
    of the returned state draw the same feature map."""
    w, vals = solve_w_rf_gram(gram, u, gamma, m, solver=solver)
    return RFTCAState(omega=None, w_rf=w, eigvals=vals, fused=tuple(fused_spec))


def rf_tca_fit(x_s, x_t, *, n_features: int, m: int, gamma: float = 1.0, sigma: float = 1.0,
               kernel: str = "gauss", mode: str = "stream", solver: str = "eigh",
               w_rf: str | None = None, ensemble: int = 1, device=None) -> RFTCAState:
    """Algorithm 1: fit W_RF on source (p, n_S) and target (p, n_T) data.

    ``w_rf="fused:<seed>"`` draws the frequency matrix inside the kernel from
    a counter-based stream; the state has ``omega=None`` and carries the spec.
    ``ensemble=S`` averages the statistics over S independently keyed draws
    (S=1 is the single-draw path); transforms use draw 0's feature map.
    ``device=None`` runs on the CUDA card and raises when there is none.
    """
    fused_seed = _check_fit_args(mode, solver, w_rf, ensemble)
    state, _ = _fit_fused(
        x_s, x_t, n_features=n_features, m=m, gamma=gamma, sigma=sigma, kernel=kernel,
        solver=solver, fused_seed=fused_seed, ensemble=ensemble,
        device=resolve_device(device),
    )
    return state


# Fused-path transform omega memo: the draw is a pure function of the spec
# (seed, N, p, sigma, kernel) and the device, so repeated serving transforms
# must not redraw it per call.  FIFO-capped with a ``regenerations`` counter.
_FUSED_OMEGA_CACHE: dict[tuple, torch.Tensor] = {}
_FUSED_OMEGA_CACHE_MAX = 16
fused_omega_regenerations: int = 0


def fused_transform_omega(state: RFTCAState, dim: int) -> torch.Tensor:
    """Draw-0 frequency matrix of a seed-fused state, memoized per spec.

    The first call per ``(seed, N, p, sigma, kernel, device)`` materializes
    the (N, p) matrix (on the card by the K4 kernel) and counts one
    regeneration; later transforms hit the cache.
    """
    global fused_omega_regenerations
    f_seed, _, f_sigma, f_kernel = state.fused
    n_features = state.w_rf.shape[0] // 2
    device = state.w_rf.device
    key = (int(f_seed), int(n_features), int(dim), float(f_sigma), str(f_kernel), str(device))
    hit = _FUSED_OMEGA_CACHE.get(key)
    if hit is not None:
        return hit
    omega = fused_omega(f_seed, n_features, dim, sigma=f_sigma, rf_kernel=f_kernel,
                        device=device)
    fused_omega_regenerations += 1
    if len(_FUSED_OMEGA_CACHE) >= _FUSED_OMEGA_CACHE_MAX:
        _FUSED_OMEGA_CACHE.pop(next(iter(_FUSED_OMEGA_CACHE)))
    _FUSED_OMEGA_CACHE[key] = omega
    return omega


def fused_omega_cache_info() -> dict[str, int]:
    """{"size", "max", "regenerations"} — the memo's observable state."""
    return {
        "size": len(_FUSED_OMEGA_CACHE),
        "max": _FUSED_OMEGA_CACHE_MAX,
        "regenerations": fused_omega_regenerations,
    }


def rf_tca_transform(state: RFTCAState, x) -> torch.Tensor:
    """F = W_RF^T Sigma(X) in R^{m x n}, on the state's device (out-of-sample).

    On the seed-fused path (``state.omega is None``) the frequency matrix is
    draw 0 of the spec, materialized once by :func:`fused_transform_omega`.
    """
    x = as_f32(x, state.w_rf.device)
    omega = state.omega
    if omega is None:
        omega = fused_transform_omega(state, x.shape[0])
    return state.w_rf.T @ rff_features(x, omega)


def rf_tca(x_s, x_t, **kw) -> tuple[torch.Tensor, torch.Tensor, RFTCAState]:
    """Convenience: fit then return (F_S (m, n_S), F_T (m, n_T), state)."""
    state = rf_tca_fit(x_s, x_t, **kw)
    return rf_tca_transform(state, x_s), rf_tca_transform(state, x_t), state
