"""Byzantine-robust aggregation rules: the ``AggregationRule`` seam.

Port of ``repro.robust.rules``.  Every FedRF-TCA aggregate is a weighted sum
over client payloads (moments, W_RF, classifier leaves) divided by a mass;
a rule owns that one contraction, ``weighted_sum(values (K, ...), weights
(K,)) -> (sum (...), mass ())``, and the target's moment merge
(``merge_moments``).  Rules (``get_rule("name[:param]")``):

==================  =========================================================
``mean``            the seed's exact weighted sum; no finite guard (NaNs
                    propagate, the fragility the robust rules fix)
``finite_mean``     mean with rows holding any NaN/Inf quarantined: weight 0
                    AND value 0 (0 * NaN would still poison the sum)
``norm_clip[:c]``   each row scaled to L2 norm <= c before the mean; without
                    ``c`` the radius is the median norm of the delivered rows
``trimmed_mean[:b]``coordinate-wise weighted trimmed mean discarding the ``b``
                    (default 0.2) weight-fraction tails per coordinate
``geomedian[:it]``  smoothed geometric median by ``it`` (default 8)
                    Weiszfeld iterations
==================  =========================================================

All rules but ``mean`` apply the finite guard first.  Every rule reports the
raw delivered mass beside its estimate (``sum = estimate * mass``), so the
``(sum + target) / (mass + 1)`` and ``sum / mass`` consumers do not depend on
the rule.  The trimmed mean sorts with ``stable=True``: ``jnp.argsort`` is
stable, and ties must order the same way for the per-row attribution.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def finite_guard(values: torch.Tensor, weights: torch.Tensor):
    """Quarantine non-finite rows: weight 0 AND value 0 (so ``0 * NaN`` can
    never leak back into a sum).  values (K, ...), weights (K,)."""
    ok = torch.isfinite(values.reshape(values.shape[0], -1)).all(dim=1)
    shaped = ok.reshape((-1,) + (1,) * (values.ndim - 1))
    return (torch.where(shaped, values, torch.zeros_like(values)),
            weights * ok.to(weights.dtype))


def _median_radius(norms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Median norm over delivered rows (undelivered rows pushed to +inf so
    they never define it), index ``(n_live - 1) // 2``; 0 when none arrived."""
    live = weights > 0
    order = torch.sort(torch.where(live, norms, torch.full_like(norms, float("inf")))).values
    n_live = live.sum()
    mid = torch.clamp_min(n_live - 1, 0) // 2
    return torch.where(n_live > 0, order[mid], torch.zeros_like(order[0]))


def _trim_weights(flat: torch.Tensor, weights: torch.Tensor, beta: float):
    """(row order per coordinate, values in that order, each row's retained
    weight in that order): the overlap of its cumulative-weight interval with
    ``[beta W, (1 - beta) W]``."""
    order = torch.argsort(flat, dim=0, stable=True)
    v_s = torch.take_along_dim(flat, order, dim=0)
    w_s = weights[order]
    cw = torch.cumsum(w_s, dim=0)
    total = cw[-1]
    lo, hi = beta * total, (1.0 - beta) * total
    eff = torch.clamp_min(torch.minimum(cw, hi) - torch.maximum(cw - w_s, lo), 0.0)
    return order, v_s, eff


class AggregationRule:
    """One merge estimator: a weighted sum + the mass it represents."""

    name: str = ""
    is_mean: bool = False  # True only for the seed rule

    def weighted_sum(self, values: torch.Tensor, weights: torch.Tensor):
        """(K, ...) values x (K,) weights -> ((...) sum, () mass); robust
        rules return ``estimate * mass``."""
        raise NotImplementedError

    def estimate(self, values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The robust weighted mean itself (sum / mass, mass-guarded)."""
        s, m = self.weighted_sum(values, weights)
        return s / torch.clamp_min(m, _EPS)

    def merge_moments(self, msgs: torch.Tensor, weights: torch.Tensor):
        """(K, 2N) moment stack + (K,) weights -> (stack, weights) the target
        trains on: the single pooled row with the total mass."""
        s, m = self.weighted_sum(msgs, weights)
        return (s / torch.clamp_min(m, _EPS))[None, :], m[None]

    def attribution(self, values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """(K,) in [0, 1]: how much of row k the rule discounted (0 trusted or
        not delivered, 1 quarantined or trimmed away)."""
        return torch.zeros(values.shape[0], dtype=values.dtype, device=values.device)


class MeanRule(AggregationRule):
    """The seed's exact-union weighted mean."""

    name, is_mean = "mean", True

    def weighted_sum(self, values, weights):
        return torch.einsum("k,k...->...", weights, values), torch.sum(weights)

    def merge_moments(self, msgs, weights):
        return msgs, weights  # untouched: the per-pair MMD over per-client messages


class FiniteMeanRule(AggregationRule):
    """Weighted mean with NaN/Inf rows quarantined (weight and value zeroed)."""

    name = "finite_mean"

    def weighted_sum(self, values, weights):
        values, weights = finite_guard(values, weights)
        return torch.einsum("k,k...->...", weights, values), torch.sum(weights)

    def attribution(self, values, weights):
        bad = ~torch.isfinite(values.reshape(values.shape[0], -1)).all(dim=1)
        return (bad & (weights > 0)).to(values.dtype)


class NormClipRule(AggregationRule):
    """Mean of rows clipped to L2 norm <= ``clip`` (median norm when None)."""

    name = "norm_clip"

    def __init__(self, clip: float | None = None):
        self.clip = clip
        if clip is not None:
            self.name = f"norm_clip:{clip:g}"

    def _scale(self, flat, weights):
        norms = torch.linalg.vector_norm(flat, dim=1)
        radius = (_median_radius(norms, weights) if self.clip is None
                  else torch.tensor(self.clip, dtype=flat.dtype, device=flat.device))
        return torch.clamp_max(radius / torch.clamp_min(norms, _EPS), 1.0)

    def weighted_sum(self, values, weights):
        values, weights = finite_guard(values, weights)
        flat = values.reshape(values.shape[0], -1)
        s = torch.einsum("k,kd->d", weights, flat * self._scale(flat, weights)[:, None])
        return s.reshape(values.shape[1:]), torch.sum(weights)

    def attribution(self, values, weights):
        raw, guarded = finite_guard(values, weights)
        scale = self._scale(raw.reshape(raw.shape[0], -1), guarded)
        # fraction of the row's norm clipped away; quarantined rows score 1
        trimmed = (1.0 - scale) * (guarded > 0)
        quarantined = (weights > 0) & (guarded <= 0)
        return torch.where(quarantined, 1.0, trimmed) * (weights > 0)


class TrimmedMeanRule(AggregationRule):
    """Coordinate-wise weighted trimmed mean (trim fraction ``beta`` per tail).

    Per coordinate the rows are sorted by value and each contributes the
    overlap of its cumulative-weight interval with ``[beta W, (1 - beta) W]``:
    weight-0 rows occupy no quantile mass, and ``beta = 0`` is the weighted
    mean."""

    name = "trimmed_mean"

    def __init__(self, beta: float = 0.2):
        if not 0.0 <= beta < 0.5:
            raise ValueError(f"trim fraction must be in [0, 0.5), got {beta}")
        self.beta = beta
        self.name = f"trimmed_mean:{beta:g}"

    def weighted_sum(self, values, weights):
        values, weights = finite_guard(values, weights)
        _, v_s, eff = _trim_weights(values.reshape(values.shape[0], -1), weights, self.beta)
        est = torch.sum(eff * v_s, dim=0) / torch.clamp_min(torch.sum(eff, dim=0), _EPS)
        mass = torch.sum(weights)
        return (est * mass).reshape(values.shape[1:]), mass

    def attribution(self, values, weights):
        guarded_v, guarded = finite_guard(values, weights)
        flat = guarded_v.reshape(guarded_v.shape[0], -1)
        order, _, eff = _trim_weights(flat, guarded, self.beta)
        # per-coordinate retained weight back in row order
        eff_orig = torch.zeros_like(eff).scatter_(0, order, eff)
        retained = torch.sum(eff_orig, dim=1) / torch.clamp_min(guarded * flat.shape[1], _EPS)
        trimmed = (1.0 - torch.clamp(retained, 0.0, 1.0)) * (guarded > 0)
        quarantined = (weights > 0) & (guarded <= 0)
        return torch.where(quarantined, 1.0, trimmed) * (weights > 0)


class GeoMedianRule(AggregationRule):
    """Smoothed geometric median, a fixed number of Weiszfeld iterations from
    the weighted mean: ``b <- sum_k (w_k / max(|v_k - b|, 1e-6)) v_k / sum``."""

    name = "geomedian"

    def __init__(self, iters: int = 8):
        if iters < 1:
            raise ValueError(f"need >= 1 Weiszfeld iteration, got {iters}")
        self.iters = int(iters)
        self.name = f"geomedian:{self.iters}"

    def _median(self, flat, weights, mass):
        b = torch.einsum("k,kd->d", weights, flat) / torch.clamp_min(mass, _EPS)
        for _ in range(self.iters):
            dist = torch.linalg.vector_norm(flat - b[None, :], dim=1)
            wz = weights / torch.clamp_min(dist, 1e-6)
            b = torch.einsum("k,kd->d", wz, flat) / torch.clamp_min(torch.sum(wz), _EPS)
        return b

    def weighted_sum(self, values, weights):
        values, weights = finite_guard(values, weights)
        flat = values.reshape(values.shape[0], -1)
        mass = torch.sum(weights)
        return (self._median(flat, weights, mass) * mass).reshape(values.shape[1:]), mass

    def attribution(self, values, weights):
        guarded_v, guarded = finite_guard(values, weights)
        flat = guarded_v.reshape(guarded_v.shape[0], -1)
        b = self._median(flat, guarded, torch.sum(guarded))
        # distance to the median, relative to the farthest delivered row
        dist = torch.linalg.vector_norm(flat - b[None, :], dim=1) * (guarded > 0)
        rel = dist / torch.clamp_min(torch.max(dist), _EPS)
        quarantined = (weights > 0) & (guarded <= 0)
        return torch.where(quarantined, 1.0, rel) * (weights > 0)


_FACTORIES = {
    "mean": MeanRule,
    "finite_mean": FiniteMeanRule,
    "norm_clip": NormClipRule,
    "trimmed_mean": TrimmedMeanRule,
    "geomedian": lambda p=8: GeoMedianRule(int(p)),
}


def rule_names() -> list[str]:
    return sorted(_FACTORIES)


def get_rule(spec) -> AggregationRule:
    """``get_rule("trimmed_mean:0.25")``: name[:param]; rule instances pass
    through (custom rules plug into the same seam)."""
    if isinstance(spec, AggregationRule):
        return spec
    name, _, param = str(spec).partition(":")
    if name not in _FACTORIES:
        raise ValueError(f"unknown aggregation rule {spec!r}; have {rule_names()}")
    return _FACTORIES[name](float(param)) if param else _FACTORIES[name]()
