"""Architecture registry: ``get_config("<arch-id>")`` for every assigned arch."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_ARCH_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internlm2-1.8b": "internlm2_1p8b",
    "zamba2-7b": "zamba2_7b",
    "smollm-360m": "smollm_360m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "smollm-135m": "smollm_135m",
    "llama-3.2-vision-90b": "llama_3p2_vision_90b",
    "musicgen-large": "musicgen_large",
    "command-r-plus-104b": "command_r_plus_104b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
