"""Functional optimizers over parameter dicts (``optim.optimizers``)."""
from repro_torch.optim.optimizers import AdamState, Optimizer, SGDState, adam, apply_updates, sgd

__all__ = ["AdamState", "Optimizer", "SGDState", "adam", "apply_updates", "sgd"]
