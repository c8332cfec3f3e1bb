"""Language-model assembly for every family: training and serve paths.

Port of ``repro.models.model`` for the ``dense``, ``moe`` (GQA or MLA
attention), ``ssm`` (Mamba2), ``hybrid`` (Mamba2 with one shared attention
block after every ``attn_every`` layers), ``vlm`` (a cross-attention block
after every ``cross_attn_every`` self-attention layers) and ``audio``
(decoder blocks fed frame embeddings, ``embeddings_in``) families.  One
:class:`LM` wraps a ModelConfig and provides

  decls / init / abstract / param_count — parameter machinery (see param.py)
  forward(params, batch)              — hidden states (training / prefill)
  loss(params, batch, n_clients)      — CE + aux + the FDA MMD head
  prefill(params, batch)              — last-token logits + the decode cache
  decode_step(params, cache, batch)   — one-token serve step with the cache
  cache_shapes / init_cache /         — cache trees (K/V, MLA's c/kr, SSM
  abstract_cache
                                        state and conv tail, the hybrid's
                                        shared-attention K/V, the VLM's
                                        image K/V)

A batch holds ``tokens`` (b, s), or ``embeddings`` (b, s, d) for
``embeddings_in``, plus ``images`` (b, n_image_tokens, d_image) for the VLM
(and ``labels`` for the loss).  The reference's stacked layer axis is kept
(``blocks.*`` leaves are ``(n_layers, ...)``, the VLM's ``cross_blocks.*``
``(n_cross, ...)``, so weights convert leaf for leaf); a Python loop over
the stack (:meth:`LM.schedule`) replaces ``lax.scan``, and with
``cfg.remat`` each layer, the hybrid's shared attention and the VLM's cross
block are checkpointed (``torch.utils.checkpoint``) where the reference
wraps them in ``jax.checkpoint``.  ``LM(cfg, rules)`` takes the
reference's optional ``ShardRules``: where they hold a mesh and
``cfg.moe_ep`` is set, the MoE blocks run expert-parallel over it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import gqa_decl, gqa_decode, gqa_forward, image_kv
from repro_torch.models.fda_head import fda_decl, fda_loss
from repro_torch.models.layers import (
    ShardRules,
    cross_entropy,
    embed,
    embedding_decl,
    rmsnorm,
    rmsnorm_decl,
    unembed,
)
from repro_torch.models.param import ParamDecl, abstract, materialize, param_count, stack_decls

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_SSM_BLOCKS = ("ssm", "hybrid")


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree stacked over the layers (views, not copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def layer_list(tree) -> list[dict]:
    """Every layer of a stacked tree, each leaf unbound once: autograd then
    assembles a stacked leaf's gradient with one stack, where a select per
    layer would write a zero-filled copy of the whole stack per layer."""
    leaves = {k: layer_list(v) if isinstance(v, dict) else torch.unbind(v)
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def _stack(leaves: list[dict]) -> dict:
    return {k: torch.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}


class LM:
    def __init__(self, cfg: ModelConfig, rules: ShardRules | None = None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family}")
        self.cfg = cfg
        self.rules = rules or ShardRules()

    # ------------------------------------------------------------------
    # parameter declarations
    # ------------------------------------------------------------------
    def decls(self) -> dict:
        cfg = self.cfg
        d: dict[str, Any] = {}
        if cfg.embeddings_in:
            d["embedding"] = {"unembed": ParamDecl((cfg.d_model, cfg.vocab_padded), "normal",
                                                   cfg.dtype)}
        else:
            d["embedding"] = embedding_decl(cfg)
        d["ln_f"] = rmsnorm_decl(cfg.d_model, cfg.dtype)
        d["fda"] = fda_decl(cfg)
        if cfg.family in _SSM_BLOCKS:
            d["blocks"] = stack_decls(B.ssm_block_decl(cfg), cfg.n_layers)
        elif cfg.family == "vlm":
            n_cross, _, _ = self._vlm_groups()
            d["blocks"] = stack_decls(B.decoder_block_decl(cfg), cfg.n_layers - n_cross)
            d["cross_blocks"] = stack_decls(B.cross_block_decl(cfg), n_cross)
        else:
            d["blocks"] = stack_decls(B.decoder_block_decl(cfg), cfg.n_layers)
        if cfg.family == "hybrid":
            d["shared_attn"] = {"ln": rmsnorm_decl(cfg.d_model, cfg.dtype),
                                "attn": gqa_decl(cfg)}
        return d

    def init(self, seed: int | torch.Generator = 0, *, device=None) -> dict[str, Any]:
        """Parameters drawn from ``seed`` (see ``param.materialize``) on
        ``device`` (``None``: the CUDA card)."""
        return materialize(self.decls(), seed, device=resolve_device(device))

    def abstract(self) -> dict[str, Any]:
        """The parameters as empty ``meta`` tensors (a dry run's input)."""
        return abstract(self.decls())

    def param_count(self) -> int:
        return param_count(self.decls())

    # ------------------------------------------------------------------
    # layer-group geometry for the non-uniform families
    # ------------------------------------------------------------------
    def _hybrid_groups(self) -> tuple[int, int]:
        """(n_groups, remainder): the shared attention runs after every group."""
        k = self.cfg.attn_every
        return self.cfg.n_layers // k, self.cfg.n_layers % k

    def _vlm_groups(self) -> tuple[int, int, int]:
        """(n_cross, self_per_group, self_remainder)."""
        n_cross = self.cfg.n_layers // (self.cfg.cross_attn_every + 1)
        per = self.cfg.cross_attn_every
        return n_cross, per, self.cfg.n_layers - n_cross - n_cross * per

    def schedule(self) -> list[tuple[str, int]]:
        """The stack in order: ``("block", i)`` runs layer i of
        ``params["blocks"]``; the hybrid's ``("attn", g)`` its shared attention
        after group g, the VLM's ``("cross", g)`` cross block g after its
        group of self layers."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            (ng, rem), per, extra = self._hybrid_groups(), cfg.attn_every, "attn"
        elif cfg.family == "vlm":
            ng, per, rem = self._vlm_groups()
            extra = "cross"
        else:
            return [("block", i) for i in range(cfg.n_layers)]
        out = []
        for g in range(ng):
            out += [("block", g * per + j) for j in range(per)] + [(extra, g)]
        return out + [("block", ng * per + j) for j in range(rem)]

    # ------------------------------------------------------------------
    # forward (training / prefill)
    # ------------------------------------------------------------------
    def _embed_in(self, params, batch):
        if self.cfg.embeddings_in:
            return batch["embeddings"].to(self.cfg.dtype)
        return embed(params["embedding"], batch["tokens"])

    def _images(self, batch):
        return batch["images"].to(self.cfg.dtype) if self.cfg.family == "vlm" else None

    def _block(self, layer, x, positions, collect_cache=False):
        if self.cfg.family in _SSM_BLOCKS:
            return B.ssm_block_forward(layer, x, self.cfg, collect_cache=collect_cache)
        return B.decoder_block_forward(layer, x, positions, self.cfg,
                                       collect_cache=collect_cache, rules=self.rules)

    def _shared_attn(self, params, x, positions, return_kv=False):
        """The hybrid's shared attention block (pre-norm residual)."""
        h = rmsnorm(params["ln"], x, self.cfg.norm_eps)
        if return_kv:
            o, kv = gqa_forward(params["attn"], h, positions, self.cfg, return_kv=True)
            return x + o, kv
        return x + gqa_forward(params["attn"], h, positions, self.cfg)

    def _cross(self, params, x, img):
        return B.cross_block_forward(params, x, image_kv(params["xattn"], img), self.cfg)

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (b, s, d), aux_loss).  With ``cfg.remat`` and grad
        mode on, each layer (and each shared attention or cross block) keeps
        only its input and runs its forward again in the backward."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        img = self._images(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        auxs = []
        blocks = layer_list(params["blocks"])
        cross = layer_list(params["cross_blocks"]) if "cross_blocks" in params else []
        for kind, i in self.schedule():
            if kind == "block":
                x, aux = run(self._block, blocks[i], x, positions)
                auxs.append(aux)
            elif kind == "attn":
                x = run(self._shared_attn, params["shared_attn"], x, positions)
            else:
                x = run(self._cross, cross[i], x, img)
        return self._finish(params, x), torch.mean(torch.stack(auxs))

    def prefill(self, params, batch):
        """Returns (last-token logits (b, vocab_padded), cache).  The cache's
        ``layers`` leaves are stacked over the blocks: ``k``/``v`` (n, b, s,
        kv, hd), MLA's ``c``/``kr``, or the SSM's ``ssm`` (n, b, h, p, n_state)
        in fp32 and ``conv`` (n, b, w-1, ch); the hybrid adds ``attn_k`` /
        ``attn_v`` (n_groups, b, s, kv, hd), the VLM ``img_k`` / ``img_v``
        (n_cross, b, n_image_tokens, kv, hd)."""
        x = self._embed_in(params, batch)
        img = self._images(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        layers, extra = [], {}
        for kind, i in self.schedule():
            if kind == "block":
                x, _, cache = self._block(layer_slice(params["blocks"], i), x, positions,
                                          collect_cache=True)
                layers.append(cache)
            elif kind == "attn":
                x, (k, v) = self._shared_attn(params["shared_attn"], x, positions,
                                              return_kv=True)
                extra.setdefault("attn_k", []).append(k)
                extra.setdefault("attn_v", []).append(v)
            else:
                cp = layer_slice(params["cross_blocks"], i)
                k, v = image_kv(cp["xattn"], img)
                x = B.cross_block_forward(cp, x, (k, v), self.cfg)
                extra.setdefault("img_k", []).append(k)
                extra.setdefault("img_v", []).append(v)
        cache = {"layers": _stack(layers), **{k: torch.stack(v) for k, v in extra.items()}}
        return self._last_logits(params, x), cache

    def _last_logits(self, params, x):
        x = self._finish(params, x[:, -1:, :])
        return self.logits(params, x)[:, 0, :]

    def _finish(self, params, x):
        return rmsnorm(params["ln_f"], x, self.cfg.norm_eps)

    def logits(self, params, hidden):
        return unembed(params["embedding"], hidden)

    # ------------------------------------------------------------------
    # training loss: CE + MoE aux + the paper's FDA MMD head
    # ------------------------------------------------------------------
    def loss(self, params, batch, n_clients: int = 1):
        """Returns (total, {"ce", "aux", "mmd"}): the mean next-token CE plus
        0.01 aux plus, with more than one client, ``fda_lambda`` times the
        FDA head's MMD (the batch laid out as (n_clients, per_client, ...))."""
        cfg = self.cfg
        hidden, aux = self.forward(params, batch)
        logits = self.logits(params, hidden)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size, sharded=cfg.sharded_ce)
        total = ce + 0.01 * aux
        mmd = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if cfg.fda_lambda and n_clients > 1:
            mmd = fda_loss(params["fda"], hidden, n_clients)
            total = total + cfg.fda_lambda * mmd
        return total, {"ce": ce, "aux": aux, "mmd": mmd}

    # ------------------------------------------------------------------
    # decode (serve) path
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, s_cache: int) -> dict:
        cfg = self.cfg
        if cfg.attn_window:
            s_cache = min(s_cache, cfg.attn_window)
        if cfg.family in _SSM_BLOCKS:
            per, n_blocks = B.ssm_cache_decl(cfg, batch), cfg.n_layers
        else:
            per = B.decoder_cache_decl(cfg, batch, s_cache)
            n_blocks = cfg.n_layers - (self._vlm_groups()[0] if cfg.family == "vlm" else 0)
        shapes: dict[str, Any] = {"layers": {k: (n_blocks, *v) for k, v in per.items()}}
        kv = (cfg.n_kv_heads, cfg.hd)
        if cfg.family == "hybrid":
            ng, _ = self._hybrid_groups()
            shapes["attn_k"] = shapes["attn_v"] = (ng, batch, s_cache, *kv)
        if cfg.family == "vlm":
            n_cross, _, _ = self._vlm_groups()
            shapes["img_k"] = shapes["img_v"] = (n_cross, batch, cfg.n_image_tokens, *kv)
        return shapes

    def _cache_tree(self, batch: int, s_cache: int, maker):
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else maker(
                v, dtype=torch.float32 if k == "ssm" else self.cfg.dtype)
                for k, v in tree.items()}

        return walk(self.cache_shapes(batch, s_cache))

    def init_cache(self, batch: int, s_cache: int, *, device=None):
        """Zeros of ``cache_shapes``: the SSM state in fp32, the rest in
        ``cfg.dtype``."""
        dev = resolve_device(device)
        return self._cache_tree(batch, s_cache,
                                lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev))

    def abstract_cache(self, batch: int, s_cache: int):
        """``init_cache``'s tree as empty ``meta`` tensors."""
        return self._cache_tree(batch, s_cache,
                                lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                                 device="meta"))

    def decode_step(self, params, cache, batch, pos: int):
        """One token for the whole stack. batch: tokens (b, 1), or embeddings
        (b, 1, d) for ``embeddings_in``; the VLM reads its image K/V from the
        cache.  pos: the position (the same across the batch).  Returns
        (logits (b, vocab_padded), cache); the cache is updated in place."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        layers = cache["layers"]
        pos = int(pos)
        for kind, i in self.schedule():
            if kind == "block":
                layer, lc = layer_slice(params["blocks"], i), layer_slice(layers, i)
                if cfg.family in _SSM_BLOCKS:
                    x, _ = B.ssm_block_decode(layer, x, lc, cfg)
                else:
                    x, _ = B.decoder_block_decode(layer, x, lc, pos, cfg)
            elif kind == "attn":
                sp = params["shared_attn"]
                h = rmsnorm(sp["ln"], x, cfg.norm_eps)
                o, _, _ = gqa_decode(sp["attn"], h, cache["attn_k"][i], cache["attn_v"][i], pos,
                                     cfg)
                x = x + o
            else:
                x = B.cross_block_forward(layer_slice(params["cross_blocks"], i), x,
                                          (cache["img_k"][i], cache["img_v"][i]), cfg)
        return self._decode_logits(params, x), cache

    def _decode_logits(self, params, x):
        x = self._finish(params, x)
        return self.logits(params, x)[:, 0, :]
