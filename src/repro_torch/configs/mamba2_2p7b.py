"""mamba2-2.7b [ssm]: 64L, d_model=2560, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]. expand=2 -> d_inner=5120,
head_dim=64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # attention-free
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="SSD [arXiv:2405.21060]",
)
