"""Functional optimizers over parameter dicts (``optim.optimizers``)."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SGDState,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    linear_schedule,
    sgd,
)

__all__ = [
    "AdamState", "Optimizer", "SGDState", "adam", "adamw", "apply_updates",
    "clip_by_global_norm", "cosine_schedule", "linear_schedule", "sgd",
]
