"""zamba2-7b [hybrid]: 81 Mamba2 layers, d_model=3584, shared GQA attention
block (32H, kv=32) applied every 6 layers, ssm_state=64, vocab=32000
[arXiv:2411.15242].

Deviation noted in DESIGN.md: the shared block is attention-only (Zamba2's
shared block also carries an MLP + per-depth LoRA which we do not replicate).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
    source="Zamba2 [arXiv:2411.15242]",
)
