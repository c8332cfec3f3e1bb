"""Model/config schema shared by all assigned architectures + input shapes.

Port of ``repro.configs.base``: every field is kept, so the architecture files
copy verbatim; ``dtype`` is a torch dtype.  ``remat`` checkpoints each layer
in training (``models.model.LM.forward``); ``sharded_ce`` picks the
reference's second cross-entropy form, which gives the same numbers.
``moe_ep`` makes an ``LM`` whose ``ShardRules`` hold a mesh run its MoE
blocks expert-parallel over that mesh (``models.moe.moe_forward_ep``);
``seq_parallel`` lays the residual's sequence over the mesh's model axis
between the blocks of ``forward`` and ``loss`` (the same numbers, other
collectives); with no mesh neither changes anything.  The other TPU switches
(``unroll_scan``, ``causal_skip``) are accepted and change nothing here:
they change how XLA schedules the reference, not the math.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek) ---
    kv_lora_rank: int = 0  # 0 => standard GQA
    rope_head_dim: int = 64
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    # --- hybrid (Zamba2): shared attention block every `attn_every` SSM layers
    attn_every: int = 0
    # --- VLM: cross-attention block every `cross_attn_every` self-attn layers
    cross_attn_every: int = 0
    n_image_tokens: int = 576
    d_image: int = 1280
    # --- audio: backbone consumes precomputed frame embeddings
    embeddings_in: bool = False
    # --- attention variants ---
    attn_window: int = 0  # 0 => full causal; >0 => sliding window
    # --- numerics / FDA head ---
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    fda_n_rff: int = 512
    fda_m: int = 64
    fda_lambda: float = 0.1
    fda_seed: int = 1234
    n_clients: int = 0  # 0 => one client per data-parallel shard
    # remat: per-layer checkpointing in training; moe_ep: the expert-parallel
    # MoE and seq_parallel: the residual's sequence over the model axis, where
    # the LM's rules hold a mesh; the rest are TPU scheduling switches,
    # accepted with no effect in the port
    remat: bool = True
    unroll_scan: bool = False
    sharded_ce: bool = False
    moe_ep: bool = False
    causal_skip: bool = False
    seq_parallel: bool = False
    source: str = ""  # provenance citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts, tiny vocab."""
        base = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64 if (self.head_dim or self.d_model // max(self.n_heads, 1)) >= 64 else 32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            dtype=torch.float32,
            fda_n_rff=32,
            fda_m=8,
            remat=False,
        )
        if self.n_experts:
            base.update(
                n_experts=4, top_k=min(self.top_k, 2),
                n_shared_experts=min(self.n_shared_experts, 1),
            )
        if self.kv_lora_rank:
            base.update(kv_lora_rank=64, rope_head_dim=32)
        if self.ssm_state:
            base.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32, ssm_chunk=16)
        if self.attn_every:
            base.update(attn_every=1, n_layers=2)
        if self.cross_attn_every:
            base.update(cross_attn_every=1, n_layers=2, n_image_tokens=16, d_image=64)
        base.update(overrides)
        return replace(self, **base)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
