"""Global parameter aggregation (paper Algorithm 4) and one-shot hard voting
(App. D).

Port of ``repro.federated.aggregation``: the FedAvg merges of the serial
plane (over lists of parameter trees), ``hard_vote`` and
``staleness_weights`` (numpy, copied).  The batched engine merges through
the ``robust.rules`` seam (re-exported here, as the reference does).
:func:`edge_weighted_sums` is the grouped-sum primitive of the two-tier
fleet merges (``fleet.hierarchy``): the K9 segment-reduce kernel on the
card, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import segment_reduce as _segment
from repro_torch.robust.rules import (  # noqa: F401  (re-export seam)
    AggregationRule,
    FiniteMeanRule,
    GeoMedianRule,
    MeanRule,
    NormClipRule,
    TrimmedMeanRule,
    get_rule,
)
from repro_torch.utils.tree import tree_mean, tree_weighted_mean

STALENESS_MODES = ("constant", "polynomial", "auto")


def staleness_weights(
    staleness,
    mode: str = "constant",
    *,
    n_samples=None,
    alpha: float = 0.5,
) -> np.ndarray:
    """Merge weights for a buffer of updates with integer ``staleness`` tags.

    ``staleness[k]`` counts server model versions between update k's dispatch
    and its consumption (0 = trained on the current model).  Modes:

    - ``constant``            w_k = 1                      (FedBuff mean)
    - ``polynomial[:alpha]``  w_k = (1 + s_k)^-alpha       (staleness discount)
    - ``auto``                w_k = n_k * (1 + s_k)^-alpha (importance x freshness;
                              n_k from ``n_samples``, uniform when omitted)

    Weights are returned unnormalized (consumers divide by their own mass so
    a weight composes with 0/1 buffer masks); all modes reduce to the uniform
    weight 1.0 at staleness 0 with uniform ``n_samples``, which is what makes
    a no-churn uniform-latency async run degenerate to the sync engine.
    """
    s = np.asarray(staleness, dtype=np.float64)
    if (s < 0).any():
        raise ValueError(f"negative staleness: {s}")
    base = mode.split(":", 1)[0]
    if base not in STALENESS_MODES:
        raise ValueError(f"unknown staleness mode {mode!r} (want {STALENESS_MODES})")
    if ":" in mode:
        alpha = float(mode.split(":", 1)[1])
    if base == "constant":
        w = np.ones_like(s)
    else:
        w = (1.0 + s) ** (-alpha)
        if base == "auto":
            n = np.ones_like(s) if n_samples is None else np.asarray(n_samples, np.float64)
            w = w * (n / n.mean())
    return w.astype(np.float32)


def edge_weighted_sums(values: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor,
                       n_edges: int) -> torch.Tensor:
    """Grouped weighted sums ``out[e] = sum_{k: seg[k]=e} w_k * values[k]``:
    values (K, D), seg_ids (K,) ints, weights (K,) -> (n_edges, D) fp32.

    On CUDA tensors one launch of the K9 kernel; on CPU tensors its plain
    version, the reference's dense weighted-membership contraction (the
    reference makes the same split between the TPU and elsewhere).  Tensors
    on different devices raise."""
    return _segment.segment_reduce(values, seg_ids, weights, n_edges)


def fedavg_w_rf(source_params: list, target_params, participating: list[int]):
    """Average W_RF over the participating sources + the target (Alg. 4 line 3),
    assign back to everyone in S_t and the target (Alg. 5 line 15)."""
    members = [source_params[i]["w_rf"] for i in participating] + [target_params["w_rf"]]
    return tree_mean(members)


def fedavg_classifier(source_params: list, participating: list[int]):
    """Average classifiers over S_t (Alg. 4 line 5) — only every T_C rounds."""
    if not participating:
        return None
    return tree_mean([source_params[i]["classifier"] for i in participating])


def fedavg_models(param_list: list, weights=None):
    """Plain FedAvg over whole models (the paper's FedAvg baseline, Table II)."""
    if weights is None:
        return tree_mean(param_list)
    return tree_weighted_mean(param_list, weights)


def hard_vote(per_source_logits: np.ndarray) -> np.ndarray:
    """One-shot hard voting over K source classifiers (App. D, settings IV/V).

    per_source_logits: (K, n, classes) -> (n,) majority-vote predictions,
    ties broken by summed logits.
    """
    preds = np.argmax(per_source_logits, axis=-1)  # (K, n)
    k, n = preds.shape
    n_classes = per_source_logits.shape[-1]
    votes = np.zeros((n, n_classes), dtype=np.int64)
    for i in range(k):
        votes[np.arange(n), preds[i]] += 1
    best = votes.max(axis=1, keepdims=True)
    tie = (votes == best).sum(axis=1) > 1
    out = votes.argmax(axis=1)
    if tie.any():
        summed = per_source_logits.sum(axis=0)  # (n, classes)
        masked = np.where(votes == best, summed, -np.inf)
        out = np.where(tie, masked.argmax(axis=1), out)
    return out
