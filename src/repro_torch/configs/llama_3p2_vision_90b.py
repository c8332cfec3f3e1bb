"""llama-3.2-vision-90b [vlm]: 100L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256, cross-attention image layers every 4 self layers
(20 cross layers) [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT frontend is a stub per the brief: input_specs() provides patch
embeddings (n_image_tokens x d_image); the cross-attention decoder is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=4,
    n_image_tokens=576,
    d_image=1280,
    source="Llama-3.2-Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
)
