"""Fault injection and Byzantine-robust defenses for FedRF-TCA.

``rules``: the :class:`AggregationRule` seam (mean, finite_mean, norm_clip,
trimmed_mean, geomedian).  ``faults``: value-level payload corruption and
Byzantine client plans for the batched engine, byte-level frame corruption
for the serial wire plane.
"""
from repro_torch.robust.faults import (
    BYTE_MODES,
    BYZANTINE_MODES,
    VALUE_MODES,
    ByteFaultInjector,
    FaultConfig,
    FaultPlan,
    build_fault_plan,
    make_byzantine_craft,
    make_corruptor,
)
from repro_torch.robust.rules import (
    AggregationRule,
    FiniteMeanRule,
    GeoMedianRule,
    MeanRule,
    NormClipRule,
    TrimmedMeanRule,
    finite_guard,
    get_rule,
    rule_names,
)

__all__ = [
    "AggregationRule", "BYTE_MODES", "BYZANTINE_MODES", "ByteFaultInjector", "FaultConfig",
    "FaultPlan", "FiniteMeanRule", "GeoMedianRule", "MeanRule", "NormClipRule",
    "TrimmedMeanRule", "VALUE_MODES", "build_fault_plan", "finite_guard", "get_rule",
    "make_byzantine_craft", "make_corruptor", "rule_names",
]
