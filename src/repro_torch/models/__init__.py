"""The LM backbone (dense and MoE decoder families, GQA or MLA), ported from ``repro.models``."""
from repro_torch.models.model import LM

__all__ = ["LM"]
