"""The LM backbone, ported from ``repro.models``: every family of the
reference (dense, MoE with GQA or MLA, Mamba2 SSM, the zamba2 hybrid, the
cross-attention VLM, audio fed frame embeddings).  Only the expert-parallel
``moe.moe_forward_ep`` waits for the port's mesh (ROADMAP queue 1, step 13i)."""
from repro_torch.models.model import LM

__all__ = ["LM"]
