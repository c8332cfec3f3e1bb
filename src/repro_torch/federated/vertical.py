"""Vertical-FL extension of FedRF-TCA (paper §VI: "By leveraging the block
matrix structure inherent in the random feature maps in Definition 2,
FedRF-TCA can be readily extended to vertical FL").

Port of ``repro.federated.vertical``.  K parties hold DISJOINT FEATURE BLOCKS
of the same samples (x = [x^(1); ...; x^(K)], party c holds x^(c) in
R^{p_c x n}).  The RFF phase matrix decomposes over blocks:

    Omega x = sum_c Omega^(c) x^(c),     Omega = [Omega^(1) | ... | Omega^(K)],

so each party computes its partial phases Z_c = Omega^(c) X^(c) in R^{N x n}
locally (from the shared seed) and only the partial-phase SUM crosses the
network — never raw features; cos/sin is applied after aggregation.  Plain
torch, as the reference computes it outside any kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.rff import draw_omega


def split_omega(omega: torch.Tensor, dims: list[int]) -> list[torch.Tensor]:
    """Column-partition Omega (N, p) into per-party blocks (N, p_c)."""
    if sum(dims) != omega.shape[1]:
        raise ValueError(f"dims {dims} must sum to p={omega.shape[1]}")
    out, start = [], 0
    for d in dims:
        out.append(omega[:, start : start + d])
        start += d
    return out


def partial_phases(omega_block: torch.Tensor, x_block: torch.Tensor) -> torch.Tensor:
    """Party-local computation: Z_c = Omega^(c) X^(c) in R^{N x n}."""
    return omega_block @ x_block


def assemble_rff(partials: list[torch.Tensor]) -> torch.Tensor:
    """Server-side: Sigma = [cos(sum Z_c); sin(sum Z_c)]/sqrt(N)."""
    z = sum(partials)
    return torch.cat([torch.cos(z), torch.sin(z)], dim=0) / math.sqrt(z.shape[0])


def vertical_rff(x_blocks: list[torch.Tensor], *, seed: int, n_features: int,
                 sigma: float = 1.0) -> torch.Tensor:
    """End-to-end vertical RFF: K parties with feature blocks -> Sigma (2N, n),
    on the blocks' device.

    Equivalent to the centralized ``rff_features`` on the concatenated
    features; communication per party is the (N, n) partial phase matrix.
    Omega is ``draw_omega(seed, ...)``: the port's stream, not the
    reference's ``jax.random`` one."""
    dims = [xb.shape[0] for xb in x_blocks]
    omega = draw_omega(seed, n_features, sum(dims), sigma=sigma, device=x_blocks[0].device)
    blocks = split_omega(omega, dims)
    partials = [partial_phases(ob, xb) for ob, xb in zip(blocks, x_blocks)]
    return assemble_rff(partials)
