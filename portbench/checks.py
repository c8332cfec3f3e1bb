"""The numbers that decide ``correct``: gaps between the program's outputs
and the reference's, each dimensionless and compared with its limit.

- ``gh_gap``: max |G_H - G_H_ref| / max |G_H_ref| (the stats pass);
- ``u_gap``: max |u - u_ref| / max |u_ref| (the stats pass);
- ``eig_resid`` (the solve): max_j sqrt(r_j^T B^-1 r_j) / lambda_ref_1 with
  r_j = G_H_ref w_j - lambda B w_j and B = gamma I + u_ref u_ref^T, for lambda
  both the program's lambda_j and the reference's lambda_ref_j: how far each
  returned pair is from the reference's problem, and each column from the
  reference's j-th eigenpair (sign, rotation within a cluster free).  The
  eigenvalues alone are no number here: a perturbation of G_H moves them only
  to second order in the vectors' terms, so TF32 statistics read within ~4x
  of float32's eigh;
- ``w_orth``: max |W^T B W - I|, W_RF's B-orthonormality (its scale);
- ``f_gap``: max |F - F_ref| / max |F_ref| (the transform).

A shape that differs, or a value that is not finite, reads infinity.
"""
from __future__ import annotations

import math

import torch


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(a.shape) != tuple(ref.shape):
        return math.inf
    a, ref = a.double().to(ref.device), ref.double()
    gap = float((a - ref).abs().max() / ref.abs().max())
    return gap if math.isfinite(gap) else math.inf


def fit_gaps(w, vals, g_h, u, *, ref_vals, ref_g_h, ref_u, gamma: float) -> dict:
    """The four fit numbers of one fit."""
    out = {"gh_gap": rel_gap(g_h, ref_g_h), "u_gap": rel_gap(u, ref_u)}
    m = ref_vals.shape[0]
    if tuple(w.shape) != (ref_g_h.shape[0], m) or tuple(vals.shape) != (m,):
        return {**out, "eig_resid": math.inf, "w_orth": math.inf}
    dev = ref_g_h.device
    w, vals = w.double().to(dev), vals.double().to(dev)
    top = float(ref_vals[0].abs())
    b = gamma * torch.eye(ref_u.shape[0], dtype=torch.float64, device=dev) + torch.outer(ref_u, ref_u)
    bw = b @ w
    gw = ref_g_h @ w
    chol = torch.linalg.cholesky(b)
    resid = 0.0
    for lam in (vals, ref_vals):
        r = gw - bw * lam
        resid = max(resid, float((r * torch.cholesky_solve(r, chol)).sum(dim=0).max()))
    orth = w.T @ bw - torch.eye(m, dtype=torch.float64, device=dev)
    gaps = {"eig_resid": math.sqrt(max(resid, 0.0)) / top, "w_orth": float(orth.abs().max())}
    return {**out, **{k: v if math.isfinite(v) else math.inf for k, v in gaps.items()}}


def worst(into: dict, gaps: dict) -> dict:
    """``into`` with each number raised to the larger of the two readings."""
    for k, v in gaps.items():
        into[k] = max(into.get(k, -math.inf), v)
    return into
