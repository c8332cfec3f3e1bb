"""Aggregation rules (``robust.rules``); faults wait for ROADMAP step 7."""
from repro_torch.robust.rules import AggregationRule, MeanRule, get_rule, rule_names

__all__ = ["AggregationRule", "MeanRule", "get_rule", "rule_names"]
