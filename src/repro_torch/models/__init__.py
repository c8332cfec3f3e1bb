"""The LM backbone, ported from ``repro.models``: every family of the
reference (dense, MoE with GQA or MLA, Mamba2 SSM, the zamba2 hybrid, the
cross-attention VLM, audio fed frame embeddings), and the expert-parallel
MoE over a ``torch.distributed`` mesh (``moe.moe_forward_ep``)."""
from repro_torch.models.layers import ShardRules
from repro_torch.models.model import LM

__all__ = ["LM", "ShardRules"]
