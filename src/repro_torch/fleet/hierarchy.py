"""Two-tier (edge -> server) merge code of the sync round.

Port of ``repro.fleet.hierarchy``.  Every FedRF-TCA aggregate is a weighted
sum over clients, so it splits exactly across an edge tier:

    flat:      agg = sum_k w_k x_k            (+ the target's own term)
    two-tier:  S_e = sum_{k in e} w_k x_k,    m_e = sum_{k in e} w_k
               agg = sum_e S_e               (the server combine)

- **W_RF / classifier** (:func:`edge_param_merge` + :func:`server_combine`):
  the two-tier merge equals the flat one for any topology and any weights,
  up to the reassociation of the float32 sum.
- **Moments** (:func:`edge_moment_merge`): the edge ships the mass-weighted
  mean ``S_e / m_e``, the exact moment message of its pooled member batch;
  the target's per-pair MMD then runs over E edge messages weighted by their
  masses.

Per-tier codecs: the engine applies the tier-1 (client -> edge) codecs to the
per-client uplinks; the tier-2 ``channel`` passed here (the round trip of a
stack of payloads) distorts the edge uplinks, the normalized partial means,
so quantization scales stay sane; the server multiplies them back by the
masses the edges report.  Without a tier-2 codec the partials pass untouched.

Every grouped sum goes through ``federated.aggregation.edge_weighted_sums``
(the K9 kernel on the card, one launch per merge), with a ones column
appended to the payload so the partial sums and the masses come out of one
reduction: ``mass[e] = sum_{k in e} w_k``.
"""
from __future__ import annotations

import torch

from repro_torch import obs

_MASS_EPS = 1e-9  # empty-edge guard; a zero mass also zeroes the merge weight


def _sums_and_mass(flat: torch.Tensor, weights: torch.Tensor, seg_ids: torch.Tensor,
                   n_edges: int):
    """((E, D) partial sums, (E,) masses) from one segment reduce."""
    # deferred: federated/__init__ imports the engine, which imports this module
    from repro_torch.federated.aggregation import edge_weighted_sums

    obs.metrics().counter("fleet.edge_merges").inc(clients=flat.shape[0], edges=n_edges)
    aug = torch.cat([flat, torch.ones((flat.shape[0], 1), dtype=flat.dtype,
                                      device=flat.device)], dim=1)
    out = edge_weighted_sums(aug, seg_ids, weights, n_edges)
    return out[:, :-1], out[:, -1]


def edge_moment_merge(msgs: torch.Tensor, weights: torch.Tensor, seg_ids: torch.Tensor,
                      n_edges: int, channel=None):
    """Per-edge pooled moment uplinks ``(pooled (E, 2N), mass (E,))`` from
    (K, 2N) messages and (K,) weights.  ``channel``: the tier-2 round trip of
    the (E, 2N) stack, or None.  A singleton member of weight 1 pools to its
    own message bit for bit."""
    sums, mass = _sums_and_mass(msgs, weights, seg_ids, n_edges)
    pooled = sums / torch.clamp_min(mass, _MASS_EPS)[:, None]
    if channel is not None:
        pooled = channel(pooled)
    return pooled, mass


def edge_param_merge(values: torch.Tensor, weights: torch.Tensor, seg_ids: torch.Tensor,
                     n_edges: int, channel=None):
    """Per-edge partial parameter sums ``(sums (E, ...), mass (E,))`` of a
    (K, ...) stack.  With a tier-2 ``channel`` the edge uplink is the
    normalized partial mean, and the server re-weights it by the mass; without
    one the raw partial sums pass untouched (pure reassociation)."""
    flat = values.reshape(values.shape[0], -1)
    sums_flat, mass = _sums_and_mass(flat, weights, seg_ids, n_edges)
    sums = sums_flat.reshape((n_edges,) + tuple(values.shape[1:]))
    if channel is not None:
        bcast = mass.reshape((-1,) + (1,) * (sums.ndim - 1))
        sums = channel(sums / torch.clamp_min(bcast, _MASS_EPS)) * bcast
    return sums, mass


def server_combine(sums: torch.Tensor, mass: torch.Tensor):
    """Complete the merge from edge partials: ``(sum_e S_e, sum_e m_e)``."""
    return torch.sum(sums, dim=0), torch.sum(mass)
