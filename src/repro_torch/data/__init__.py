"""Seeded synthetic data (numpy-only copies of ``repro.data``): domains and
the LM token stream."""
from repro_torch.data.domains import (
    Domain,
    batches,
    make_domains,
    make_implicit_domains,
    normalize_unit,
    train_test_split,
)
from repro_torch.data.lm import TokenStream

__all__ = [
    "Domain", "TokenStream", "batches", "make_domains", "make_implicit_domains",
    "normalize_unit", "train_test_split",
]
