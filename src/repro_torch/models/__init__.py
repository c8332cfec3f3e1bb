"""The LM backbone (dense GQA decoder family), ported from ``repro.models``."""
from repro_torch.models.model import LM

__all__ = ["LM"]
