"""deepseek-v2-lite-16b [moe]: 27L, d_model=2048, 16H MLA (kv_lora=512),
expert d_ff=1408, vocab=102400, 64 routed experts top-6 + 2 shared.

MLA with decoupled RoPE head (64) and absorbed decode [arXiv:2405.04434].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    kv_lora_rank=512,
    rope_head_dim=64,
    source="DeepSeek-V2 [arXiv:2405.04434]",
)
