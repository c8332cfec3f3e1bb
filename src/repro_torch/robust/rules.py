"""The ``AggregationRule`` seam: who owns every weighted merge of a round.

Port of ``repro.robust.rules``.  Every FedRF-TCA aggregate is a weighted sum
over client payloads (moments, W_RF, classifier leaves) divided by a mass;
a rule owns that one contraction, ``weighted_sum(values (K, ...), weights
(K,)) -> (sum (...), mass ())``, and the target's moment merge
(``merge_moments``).  This slice ports the seed rule, :class:`MeanRule`,
which every trainer uses by default.  The robust rules (``finite_mean``,
``norm_clip``, ``trimmed_mean``, ``geomedian``) are ROADMAP queue 1 step 7:
:func:`get_rule` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import torch

_EPS = 1e-12
ROBUST_RULES = ("finite_mean", "geomedian", "norm_clip", "trimmed_mean")


class AggregationRule:
    """One merge estimator: a weighted sum + the mass it represents."""

    name: str = ""
    is_mean: bool = False  # True only for the seed rule

    def weighted_sum(self, values: torch.Tensor, weights: torch.Tensor):
        """(K, ...) values x (K,) weights -> ((...) sum, () mass)."""
        raise NotImplementedError

    def merge_moments(self, msgs: torch.Tensor, weights: torch.Tensor):
        """(K, 2N) moment stack + (K,) weights -> (stack, weights) the target
        trains on: the single pooled row with the total mass."""
        s, m = self.weighted_sum(msgs, weights)
        return (s / torch.clamp_min(m, _EPS))[None, :], m[None]


class MeanRule(AggregationRule):
    """The seed's exact-union weighted mean."""

    name, is_mean = "mean", True

    def weighted_sum(self, values, weights):
        return torch.einsum("k,k...->...", weights, values), torch.sum(weights)

    def merge_moments(self, msgs, weights):
        return msgs, weights  # untouched: the per-pair MMD over per-client messages


def rule_names() -> list[str]:
    return sorted(("mean",) + ROBUST_RULES)


def get_rule(spec) -> AggregationRule:
    """``get_rule("mean")``; rule instances pass through."""
    if isinstance(spec, AggregationRule):
        return spec
    name = str(spec).partition(":")[0]
    if name == "mean":
        return MeanRule()
    if name in ROBUST_RULES:
        raise NotImplementedError(
            f"aggregation rule {name!r} is not ported yet (ROADMAP queue 1 step 7, robust/)"
        )
    raise ValueError(f"unknown aggregation rule {spec!r}; have {rule_names()}")
