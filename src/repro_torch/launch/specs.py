"""Abstract input specs and their placements for every (arch x input-shape).

Port of ``repro.launch.specs``.  ``input_specs`` returns empty ``meta``
tensors of the reference's shapes and dtypes (nothing allocated);
``input_pspecs`` and ``cache_pspecs`` their placements, each a tuple with
one entry a dimension: a mesh-axis name, a tuple of them, or ``None``
(replicated), position for position the reference's ``PartitionSpec``.
Batch dims go over the data axes when divisible; for ``long_500k``
(global_batch = 1) attention caches place their *sequence* dim over the data
axes instead (context parallelism for the cache), and SSM states place their
head dim over model.  ``LM.init_cache`` and ``LM.decode_step`` place their
caches by these placements under a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import ShardRules
from repro_torch.models.model import LM


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _bspec(rules: ShardRules, batch: int):
    n_data = rules_data_size(rules)
    return rules.batch if batch % n_data == 0 else None


def rules_data_size(rules: ShardRules) -> int:
    """The ranks over the batch axes: the mesh's, where the rules hold one,
    else the production mesh's (16 per axis, pod = 2)."""
    mesh = getattr(rules, "mesh", None)
    if mesh is not None:
        names = list(mesh.mesh_dim_names)
        return int(np.prod([mesh.size(names.index(a)) for a in rules.batch_axes if a in names]))
    sizes = {"data": 16, "pod": 2, "model": rules.model_size}
    n = 1
    for a in rules.batch_axes:
        n *= sizes.get(a, 1)
    return n


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.embeddings_in:
            out["embeddings"] = _meta((b, s, cfg.d_model), cfg.dtype)
        else:
            out["tokens"] = _meta((b, s), i32)
        if shape.kind == "train":
            out["labels"] = _meta((b, s), i32)
        if cfg.family == "vlm":
            out["images"] = _meta((b, cfg.n_image_tokens, cfg.d_image), cfg.dtype)
        return out
    # decode: one new token against a seq_len cache
    if cfg.embeddings_in:
        return {"embeddings": _meta((b, 1, cfg.d_model), cfg.dtype)}
    return {"tokens": _meta((b, 1), i32)}


def input_pspecs(cfg: ModelConfig, shape: InputShape, rules: ShardRules) -> dict:
    bs = _bspec(rules, shape.global_batch)
    out = {}
    for k in input_specs(cfg, shape):
        if k in ("tokens", "labels"):
            out[k] = (bs, None)
        elif k in ("embeddings", "images"):
            out[k] = (bs, None, None)
    return out


def cache_pspecs(model: LM, shape: InputShape, rules: ShardRules) -> dict:
    """Placement tree matching ``LM.cache_shapes()``."""
    return cache_placements(model, shape.global_batch, shape.seq_len, rules)


def cache_placements(model: LM, batch: int, s_cache: int, rules: ShardRules) -> dict:
    """:func:`cache_pspecs` for a global ``batch`` and a cache of ``s_cache``."""
    bs = _bspec(rules, batch)
    # when the batch can't shard, shard the attention cache's sequence over data
    seq_spec = None if bs is not None else rules.batch
    m = rules.model_axis

    def leaf_spec(key: str, shp: tuple) -> tuple:
        # every leaf is stacked: axis 0 = layers / groups
        if key in ("k", "v", "attn_k", "attn_v"):  # (L, b, S, kv, hd)
            kv_spec = m if shp[3] % rules.model_size == 0 else None
            return (None, bs, seq_spec, kv_spec, None)
        if key in ("c", "kr"):  # MLA latent: (L, b, S, r)
            return (None, bs, seq_spec, None)
        if key in ("img_k", "img_v"):  # (n_cross, b, n_img, kv, hd)
            kv_spec = m if shp[3] % rules.model_size == 0 else None
            return (None, bs, None, kv_spec, None)
        if key == "ssm":  # (L, b, h, p, n)
            h_spec = m if shp[2] % rules.model_size == 0 else None
            return (None, bs, h_spec, None, None)
        if key == "conv":  # (L, b, w-1, ch)
            ch_spec = m if shp[3] % rules.model_size == 0 else None
            return (None, bs, None, ch_spec)
        raise KeyError(key)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf_spec(k, v) for k, v in tree.items()}

    return walk(model.cache_shapes(batch, s_cache))
