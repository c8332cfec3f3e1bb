"""musicgen-large [audio]: 48L decoder-only over EnCodec tokens, d_model=2048,
32H (kv=32, MHA), d_ff=8192, vocab=2048 [arXiv:2306.05284].

The mel/EnCodec frontend is a stub per the brief: input_specs() provides
frame embeddings (seq x d_model); the decoder transformer is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embeddings_in=True,
    source="MusicGen [arXiv:2306.05284]",
)
