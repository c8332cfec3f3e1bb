"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4), expert
d_ff=1536, 128 experts top-8, vocab=151936 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    source="Qwen3-MoE [hf:Qwen/Qwen3-30B-A3B]",
)
