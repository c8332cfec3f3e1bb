"""Plain reference of RF-TCA's fit and transform (paper Algorithm 1).

Imports torch and numpy only, nothing of the program under test: the
benchmark judges the program's outputs against what this file works out
again from the same inputs (X, the fused seed, sigma, gamma, m).

- ``omega``: a frozen copy of the seed-fused frequency matrix's law,
  threefry-2x32 (20 rounds) on the counter (row, col) under the key
  (seed, draw), then Box-Muller (gauss) or tan-Cauchy (laplace) in float32,
  times f32(1/sigma).  The uint32 arithmetic runs in int64 masked to 32 bits.
- ``stats``: G_H = Sigma H Sigma^T and u = Sigma ell from X in blocks of
  columns, Sigma = [cos; sin](Omega X) / sqrt(N) never whole.
- ``solve``: the top m of G_H w = lambda (gamma I + u u^T) w by the Cholesky
  factor L of B = gamma I + u u^T: eigh of L^-1 G_H L^-T, w = L^-T y.
- ``transform``: W^T Sigma(X).

``precision="fp64"`` is the reference.  ``precision="tf32"`` is its control:
every product takes its operands rounded to TF32 (10 mantissa bits, round to
nearest) and sums in float32, cos, sin and the solve run in float32, so the
same code shows what one step below the stated float32 reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TWO_PI = float(np.float32(2 * math.pi))
_PI = float(np.float32(math.pi))
PRECISIONS = ("fp64", "tf32")


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32, 20 rounds, of counters (c0, c1) under the key (k0, k1);
    int64 tensors holding uint32 values in and out."""
    ks = (k0 & MASK, k1 & MASK, (_PARITY ^ k0 ^ k1) & MASK)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK
    return x0, x1


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 bits as a float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def gauss(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Box-Muller in float32: sqrt(-2 log1p(-u1)) cos(f32(2 pi) u2)."""
    return torch.sqrt(-2.0 * torch.log1p(-_uniform(b0))) * torch.cos(_TWO_PI * _uniform(b1))


def cauchy(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """tan(f32(pi) (u - 0.5)) on the first word, in float32."""
    return torch.tan(_PI * (_uniform(b0) - 0.5))


def threefry_bits(seed: int, rows: int, cols: int, *, draw: int = 0, device="cpu"):
    """The bit pair of every element of a (rows, cols) block at the origin."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None].expand(rows, cols)
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :].expand(rows, cols)
    return threefry2x32(seed & MASK, draw, r, c)


def omega(seed: int, n_features: int, dim: int, *, sigma: float, kernel: str = "gauss",
          draw: int = 0, device="cpu") -> torch.Tensor:
    """The (N, p) float32 frequency matrix of draw ``draw`` under ``seed``."""
    law = {"gauss": gauss, "laplace": cauchy}[kernel]
    om = law(*threefry_bits(seed, n_features, dim, draw=draw, device=device))
    if sigma != 1.0:
        om = om * float(np.float32(1.0 / sigma))
    return om


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp64":
        return a.double() @ b.double()
    return tf32(a) @ tf32(b)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "fp64" else torch.float32


def features(x: torch.Tensor, om: torch.Tensor, precision: str) -> torch.Tensor:
    """Sigma = [cos; sin](Omega X) / sqrt(N), (2N, n), in the precision's type."""
    z = _mm(om, x, precision)
    return torch.cat([torch.cos(z), torch.sin(z)]) / math.sqrt(om.shape[0])


def stats(x_s: torch.Tensor, x_t: torch.Tensor, om: torch.Tensor, *, precision: str = "fp64",
          block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """(G_H (2N, 2N), u (2N,)) over the columns of x_s then x_t, ell_i = 1/n_S
    on the source and -1/n_T on the target, in blocks of ``block`` columns."""
    dt = _dtype(precision)
    two_n = 2 * om.shape[0]
    g = torch.zeros((two_n, two_n), dtype=dt, device=om.device)
    col_sum = torch.zeros(two_n, dtype=dt, device=om.device)
    u = torch.zeros_like(col_sum)
    for x, ell in ((x_s, 1.0 / x_s.shape[1]), (x_t, -1.0 / x_t.shape[1])):
        for c0 in range(0, x.shape[1], block):
            f = features(x[:, c0:c0 + block], om, precision)
            g += _mm(f, f.T, precision)
            s = f.sum(dim=1)
            col_sum += s
            u += ell * s
    n = x_s.shape[1] + x_t.shape[1]
    g_h = g - torch.outer(col_sum, col_sum) / n
    return 0.5 * (g_h + g_h.T), u


def b_matrix(u: torch.Tensor, gamma: float) -> torch.Tensor:
    """B = gamma I + u u^T."""
    return gamma * torch.eye(u.shape[0], dtype=u.dtype, device=u.device) + torch.outer(u, u)


def solve(g_h: torch.Tensor, u: torch.Tensor, *, gamma: float,
          m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(W (2N, m), lambda (m,), descending): the top m of G_H w = lambda B w,
    W B-orthonormal, in the type of ``g_h``."""
    chol = torch.linalg.cholesky(b_matrix(u, gamma))
    c = torch.linalg.solve_triangular(chol, g_h, upper=False)
    c = torch.linalg.solve_triangular(chol, c.T, upper=False)
    vals, vecs = torch.linalg.eigh(0.5 * (c + c.T))
    vals, vecs = vals.flip(0)[:m], vecs.flip(1)[:, :m]
    return torch.linalg.solve_triangular(chol.T, vecs, upper=True), vals


def fit(x_s, x_t, *, n_features: int, m: int, gamma: float, sigma: float, kernel: str,
        fused_seed: int, precision: str = "fp64"):
    """(W, lambda, G_H, u) of one seed-fused fit (one draw of Omega)."""
    om = omega(fused_seed, n_features, x_s.shape[0], sigma=sigma, kernel=kernel,
               device=x_s.device)
    g_h, u = stats(x_s, x_t, om, precision=precision)
    w, vals = solve(g_h, u, gamma=gamma, m=m)
    return w, vals, g_h, u


def transform(w: torch.Tensor, x: torch.Tensor, om: torch.Tensor, *,
              precision: str = "fp64", block: int = 16384) -> torch.Tensor:
    """F = W^T Sigma(X), (m, n), in blocks of ``block`` columns."""
    return torch.cat([_mm(w.T, features(x[:, c0:c0 + block], om, precision), precision)
                      for c0 in range(0, x.shape[1], block)], dim=1)


class ControlProgram:
    """The reference put in the program's place, at ``precision`` (the
    benchmark's control is ``"tf32"``); the interface of
    ``portbench.program.PortProgram``."""

    def __init__(self, precision: str = "tf32"):
        _dtype(precision)
        self.precision = precision

    def fit(self, x_s, x_t, *, cfg: dict, sigma: float, fused_seed: int):
        if cfg.get("ensemble", 1) != 1:
            raise ValueError("the control draws one Omega (ensemble 1)")
        om = omega(fused_seed, cfg["n_features"], x_s.shape[0], sigma=sigma,
                   kernel=cfg["kernel"], device=x_s.device)
        g_h, u = stats(x_s, x_t, om, precision=self.precision)
        w, vals = solve(g_h, u, gamma=cfg["gamma"], m=cfg["m"])
        return w, vals, g_h, u, (w, om)

    def transform(self, state, x: torch.Tensor) -> torch.Tensor:
        w, om = state
        return transform(w, x, om, precision=self.precision)
