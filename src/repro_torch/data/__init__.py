"""Seeded synthetic domains (a numpy-only copy of ``repro.data.domains``)."""
from repro_torch.data.domains import (
    Domain,
    batches,
    make_domains,
    make_implicit_domains,
    normalize_unit,
    train_test_split,
)

__all__ = [
    "Domain", "batches", "make_domains", "make_implicit_domains", "normalize_unit",
    "train_test_split",
]
