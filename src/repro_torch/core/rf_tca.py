"""RF-TCA (paper Algorithm 1, Section III).

Port of ``repro.core.rf_tca``.  Finds W_RF in R^{2N x m} as the top-m
solutions of the symmetric definite generalized eigenproblem

    G_H w = lambda (gamma I + u u^T) w,     G_H = Sigma H Sigma^T,  u = Sigma l.

**Statistics pass** (``mode``):

- ``"stream"`` (default): X is consumed in chunks of sample columns and G_H
  and u are accumulated directly; the (2N, n) RFF matrix Sigma never exists.
  With ``w_rf=None`` the frequency matrix Omega is drawn by
  :func:`repro_torch.core.rff.draw_omega` and read by the kernels K2/K3
  (:func:`streaming_gram`); with ``w_rf="fused:<seed>"`` it is drawn inside
  the kernels K5/K6 from the counter-based threefry stream, S draws averaged
  (``ensemble=S``), and never stored (:func:`fused_streaming_gram`).
- ``"dense"``: Sigma is materialized by K1 and G_H = Sigma H Sigma^T comes
  from the centered Gram kernel K8 (:func:`_dense_gram`), the benchmark
  baseline and small-n reference.

**Solve** (``solver``): B = gamma I + u u^T is identity plus rank one, so
B^{-1/2} = gamma^{-1/2}(I + c uhat uhat^T) (Sherman–Morrison whitening); the
whitened C = B^{-1/2} G_H B^{-1/2} is then diagonalized by

- ``"eigh"``: ``torch.linalg.eigh`` of the whole C (the reference also
  leaves this to a library);
- ``"lobpcg"``: matrix-free top-m LOBPCG on the products C v (O(N^2 m) per
  iteration), falling back to eigh when 5m >= 2N as the reference does;
- ``"cholesky"`` (``mode="dense"`` only): the original Cholesky whitening and
  full eigh, kept verbatim as the cross-check of the two above.

**Transform**: W_RF^T Sigma(X) by the K1 kernel; on the seed-fused path draw
0's Omega is materialized once per spec by the memo
(:func:`fused_transform_omega`).
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch.core.kernels_math import ell_vector
from repro_torch.core.rff import draw_omega, rff_features
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


class LobpcgNotConverged(RuntimeWarning):
    """LOBPCG stopped at its iteration limit with eigenpairs not converged."""


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


def streaming_gram(x: torch.Tensor, ell: torch.Tensor,
                   omega: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G_H (2N, 2N), u (2N,)) fp32 from X (p, n) in one chunked pass.

    CUDA tensors go through the streamed Gram kernels with Omega read from
    the operand (K2/K3), CPU tensors through their plain version.  The
    reference's ``block``, ``use_pallas`` and ``tile`` are TPU knobs: the
    card's chunk plan (``kernels.rff_gram_stream.gram_tile_plan``) decides.
    """
    return ops.rff_gram_stream(x, omega, ell)


def _dense_gram(sigma: torch.Tensor, ell: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Materializing reference: (G_H, u) from an explicit Sigma (2N, n); G_H
    from the centered Gram kernel (K8) on a CUDA tensor."""
    g_h = ops.centered_gram(sigma)
    return 0.5 * (g_h + g_h.T), sigma @ ell


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
    """Top-m (vals descending, vecs) of a symmetric matrix (its lower triangle
    is read)."""
    vals, vecs = torch.linalg.eigh(cmat)
    return vals.flip(0)[:m], vecs.flip(1)[:, :m]


def _apply_whiten(u: torch.Tensor, gamma: float, vecs: torch.Tensor) -> torch.Tensor:
    """w = B^{-1/2} vecs (the final back-transform)."""
    return _whiten_half(u, gamma)(vecs)


def _lobpcg_top(matvec: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, *,
                iters: int, tol: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of a symmetric operator given by its products.

    Locally optimal block CG: each iteration orthonormalizes the search block
    [X, R, P] (one Householder QR, so residual or direction columns that have
    collapsed cannot break it), applies the operator to it and keeps the top
    k Ritz pairs.  Stopping rule and ``tol`` as the reference's
    ``lobpcg_standard``: pair i has converged when |A x_i - theta_i x_i| <
    tol * 10 n (|A x_i| + theta_i), ``tol=None`` being the dtype's epsilon; it
    stops when all k have, or after ``iters`` iterations, and then warns
    (:class:`LobpcgNotConverged`) instead of returning quietly.
    """
    n, k = x0.shape
    tol = torch.finfo(x0.dtype).eps if tol is None else tol
    x = torch.linalg.qr(x0).Q
    ax = matvec(x)
    theta = (x * ax).sum(dim=0)
    p = None
    converged, it = 0, 0
    while True:
        r = ax - x * theta
        limit = tol * 10 * n * (torch.linalg.vector_norm(ax, dim=0) + theta)
        converged = int((torch.linalg.vector_norm(r, dim=0) < limit).sum())
        if converged == k or it == iters:
            break
        block = torch.cat([x, r] if p is None else [x, r, p], dim=1)
        basis = torch.linalg.qr(block).Q
        a_basis = matvec(basis)
        theta, z = _top_eigh(basis.T @ a_basis, k)  # Rayleigh–Ritz
        x, ax = basis @ z, a_basis @ z
        p = basis[:, k:] @ z[k:]
        it += 1
    if converged < k:
        warnings.warn(f"LOBPCG: {converged} of {k} eigenpairs converged after {iters} "
                      f"iterations (tol {tol:.3g})", LobpcgNotConverged, stacklevel=3)
    return theta, x


def _solve_whitened_top_m(g_h: torch.Tensor, u: torch.Tensor, gamma: float, *, m: int,
                          iters: int, tol: float | None,
                          seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m of the whitened operator: matrix-free LOBPCG when the [X, R, P]
    search block fits (5m < 2N, the reference's guard), eigh otherwise.  The
    start block is drawn from a ``torch.Generator`` seeded by ``seed``: not
    the reference's bits, the same role."""
    bihalf = _whiten_half(u, gamma)
    if 5 * m < g_h.shape[0]:
        gen = torch.Generator(device=g_h.device).manual_seed(seed)
        x0 = torch.randn((g_h.shape[0], m), generator=gen, dtype=g_h.dtype, device=g_h.device)
        vals, vecs = _lobpcg_top(lambda v: bihalf(g_h @ bihalf(v)), x0, iters=iters, tol=tol)
    else:
        vals, vecs = _top_eigh(_whitened_cmat(g_h, u, gamma), m)
    return bihalf(vecs), vals


def solve_w_rf_gram(g_h: torch.Tensor, u: torch.Tensor, gamma: float, m: int, *,
                    solver: str = "eigh", lobpcg_iters: int = 100,
                    lobpcg_tol: float | None = None,
                    seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m solution of (7) from the streamed statistics (G_H, u).

    Returns (w_rf (2N, m), eigvals (m,)).  ``solver="lobpcg"`` iterates on the
    products C v without forming C (``lobpcg_iters``, ``lobpcg_tol`` and
    ``seed`` as in the reference); ``"eigh"`` diagonalizes the whole C.
    """
    if solver == "lobpcg":
        return _solve_whitened_top_m(g_h, u, gamma, m=m, iters=lobpcg_iters, tol=lobpcg_tol,
                                     seed=seed)
    if solver != "eigh":
        raise ValueError(f"unknown solver {solver!r}")
    vals, vecs = _top_eigh(_whitened_cmat(g_h, u, gamma), m)
    return _apply_whiten(u, gamma, vecs), vals


def solve_w_rf_cholesky(sigma: torch.Tensor, ell: torch.Tensor, gamma: float,
                        m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Original Cholesky whitening + full eigh (the seed dense path), kept
    verbatim as the baseline and cross-check of the Sherman–Morrison solvers."""
    two_n = sigma.shape[0]
    g_h, u = _dense_gram(sigma, ell)
    b = gamma * torch.eye(two_n, dtype=sigma.dtype, device=sigma.device) + torch.outer(u, u)
    chol = torch.linalg.cholesky(b)
    li_g = torch.linalg.solve_triangular(chol, g_h, upper=False)
    c = torch.linalg.solve_triangular(chol, li_g.T, upper=False).T
    c = 0.5 * (c + c.T)
    vals, vecs = torch.linalg.eigh(c)
    vals = vals.flip(0)[:m]
    vecs = vecs.flip(1)[:, :m]
    w_rf = torch.linalg.solve_triangular(chol.T, vecs, upper=True)
    return w_rf, vals


def solve_w_rf(sigma: torch.Tensor, ell: torch.Tensor, gamma: float, m: int, *,
               solver: str = "eigh") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m solution of (7) given an explicit RFF matrix Sigma (2N, n).

    ``solver="cholesky"`` reproduces the original implementation;
    "eigh"/"lobpcg" use Sherman–Morrison whitening (same eigenpairs, W
    B-orthonormal in both cases).
    """
    if solver == "cholesky":
        return solve_w_rf_cholesky(sigma, ell, gamma, m)
    g_h, u = _dense_gram(sigma, ell)
    return solve_w_rf_gram(g_h, u, gamma, m, solver=solver)


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


def _fit_fused(x_s, x_t, *, n_features: int, m: int, gamma: float, sigma: float, seed: int,
               kernel: str, solver: str, fused_seed: int, ensemble: int,
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
    w, vals = solve_w_rf_gram(g_h, u, gamma, m, solver=solver, seed=seed)
    state = RFTCAState(omega=None, w_rf=w, eigvals=vals,
                       fused=(fused_seed, ensemble, sigma, kernel))
    stats = {"gram": g_h, "u": u, "gamma": float(gamma), "m": int(m), "solver": str(solver),
             "seed": int(seed)}
    return state, stats


def _check_fit_args(mode: str, solver: str, w_rf, ensemble: int) -> int | None:
    """The reference's argument checks; returns the fused seed or None."""
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
    return fused_seed


def rf_tca_fit_with_stats(x_s, x_t, *, n_features: int, m: int, gamma: float = 1.0,
                          sigma: float = 1.0, seed: int = 0, kernel: str = "gauss",
                          solver: str = "eigh", w_rf: str | None = None, ensemble: int = 1,
                          device=None) -> tuple[RFTCAState, dict]:
    """Seed-fused :func:`rf_tca_fit` that also returns the fit statistics
    ``{"gram", "u", "gamma", "m", "solver", "seed"}`` — everything
    :func:`rf_tca_resolve` needs to re-solve W_RF from updated moments."""
    fused_seed = _parse_fused_spec(w_rf)
    if fused_seed is None:
        raise ValueError(
            'rf_tca_fit_with_stats requires the seed-fused path: pass w_rf="fused:<seed>"'
        )
    if solver not in ("eigh", "lobpcg"):
        raise ValueError(f"unknown solver {solver!r}")
    return _fit_fused(
        x_s, x_t, n_features=n_features, m=m, gamma=gamma, sigma=sigma, seed=seed,
        kernel=kernel, solver=solver, fused_seed=fused_seed, ensemble=ensemble,
        device=resolve_device(device),
    )


def rf_tca_resolve(gram: torch.Tensor, u: torch.Tensor, *, gamma: float, m: int,
                   solver: str = "eigh", seed: int = 0, fused_spec: tuple) -> RFTCAState:
    """Re-solve W_RF from statistics alone (no data pass); ``fused_spec`` is
    the ``(seed, ensemble, sigma, kernel)`` of the original fit, so transforms
    of the returned state draw the same feature map."""
    if solver not in ("eigh", "lobpcg"):
        raise ValueError(f"unknown solver {solver!r}")
    w, vals = solve_w_rf_gram(gram, u, gamma, m, solver=solver, seed=seed)
    return RFTCAState(omega=None, w_rf=w, eigvals=vals, fused=tuple(fused_spec))


def rf_tca_fit(x_s, x_t, *, n_features: int, m: int, gamma: float = 1.0, sigma: float = 1.0,
               seed: int = 0, kernel: str = "gauss", mode: str = "stream",
               solver: str = "eigh", w_rf: str | None = None, ensemble: int = 1,
               device=None) -> RFTCAState:
    """Algorithm 1: fit W_RF on source (p, n_S) and target (p, n_T) data.

    ``mode="stream"`` (default) never materializes the (2N, n) RFF matrix;
    ``mode="dense"`` is the original materializing path (solver
    ``"cholesky"`` reproduces the seed implementation).  With ``w_rf=None``
    Omega is drawn from ``seed`` by :func:`repro_torch.core.rff.draw_omega`
    (a ``torch.Generator`` stream, not the reference's ``jax.random`` bits)
    and kept in the state; ``seed`` also seeds the LOBPCG start block.

    ``w_rf="fused:<seed>"`` draws the frequency matrix inside the kernel from
    a counter-based stream; the state has ``omega=None`` and carries the spec.
    ``ensemble=S`` averages the statistics over S independently keyed draws
    (S=1 is the single-draw path); transforms use draw 0's feature map.

    The reference's ``use_pallas`` and ``block`` are knobs of the TPU and are
    left out: on the card every path runs its kernels, and the chunk plan
    (``kernels.rff_gram_stream.gram_tile_plan``) sets the block.
    ``device=None`` runs on the CUDA card and raises when there is none.
    """
    fused_seed = _check_fit_args(mode, solver, w_rf, ensemble)
    dev = resolve_device(device)
    if fused_seed is not None:
        state, _ = _fit_fused(
            x_s, x_t, n_features=n_features, m=m, gamma=gamma, sigma=sigma, seed=seed,
            kernel=kernel, solver=solver, fused_seed=fused_seed, ensemble=ensemble, device=dev,
        )
        return state
    x_s = as_f32(x_s, dev)
    x_t = as_f32(x_t, dev)
    omega = draw_omega(seed, n_features, x_s.shape[0], sigma=sigma, kernel=kernel, device=dev)
    x = torch.cat([x_s, x_t], dim=1).contiguous()
    ell = ell_vector(x_s.shape[1], x_t.shape[1], device=dev)
    if mode == "stream":
        g_h, u = streaming_gram(x, ell, omega)
        w, vals = solve_w_rf_gram(g_h, u, gamma, m, solver=solver, seed=seed)
    else:
        w, vals = solve_w_rf(rff_features(x, omega), ell, gamma, m, solver=solver)
    return RFTCAState(omega=omega, w_rf=w, eigvals=vals)


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
