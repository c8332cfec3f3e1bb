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
wraps them in ``jax.checkpoint``.

``LM(cfg, rules)`` takes the reference's ``ShardRules``.  Every declaration
carries the reference's placement (:meth:`LM.specs`, :meth:`LM.cache_specs`).
Where ``rules.mesh`` is a ``DeviceMesh`` with the axes ("data", "model") or
("pod", "data", "model"), the LM runs SPMD over it, one process a rank:
``init`` and ``abstract`` give this rank's shards, each method takes this
rank's batch (split over the data axes) and runs the blocks on this rank's
heads, d_ff, experts and d_inner (``models.parallel`` places the
collectives where XLA's partitioner places the reference's), and ``loss``
returns the global loss on every rank (the CE's mean over the global
tokens, the MoE's global aux, the FDA head's federation mean).  With
``cfg.seq_parallel`` the residual's sequence lies over the model axis
between the blocks in ``forward`` and ``loss`` (the reference's ``_sp``):
the row-parallel reduces become reduce-scatters, each block's input an
all-gather, and the norms run on sequence shards.  ``cfg.moe_ep`` runs the
MoE blocks expert-parallel over the mesh.
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
from repro_torch.models.param import (
    ParamDecl,
    abstract,
    local_shape,
    materialize,
    param_count,
    shard,
    specs,
    stack_decls,
)
from repro_torch.models.parallel import Par

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
        cfg, rules = self.cfg, self.rules
        d: dict[str, Any] = {}
        if cfg.embeddings_in:
            v = cfg.vocab_padded
            d["embedding"] = {"unembed": ParamDecl((cfg.d_model, v), "normal", cfg.dtype,
                                                   spec=(None, rules.tp(v)))}
        else:
            d["embedding"] = embedding_decl(cfg, rules)
        d["ln_f"] = rmsnorm_decl(cfg.d_model, cfg.dtype)
        d["fda"] = fda_decl(cfg)
        if cfg.family in _SSM_BLOCKS:
            d["blocks"] = stack_decls(B.ssm_block_decl(cfg, rules), cfg.n_layers)
        elif cfg.family == "vlm":
            n_cross, _, _ = self._vlm_groups()
            d["blocks"] = stack_decls(B.decoder_block_decl(cfg, rules), cfg.n_layers - n_cross)
            d["cross_blocks"] = stack_decls(B.cross_block_decl(cfg, rules), n_cross)
        else:
            d["blocks"] = stack_decls(B.decoder_block_decl(cfg, rules), cfg.n_layers)
        if cfg.family == "hybrid":
            d["shared_attn"] = {"ln": rmsnorm_decl(cfg.d_model, cfg.dtype),
                                "attn": gqa_decl(cfg, rules)}
        return d

    @property
    def mesh(self):
        return getattr(self.rules, "mesh", None)

    def init(self, seed: int | torch.Generator = 0, *, device=None) -> dict[str, Any]:
        """Parameters drawn from ``seed`` (see ``param.materialize``) on
        ``device`` (``None``: the CUDA card); under a mesh, this rank's
        shards of them (the whole draw, then cut)."""
        params = materialize(self.decls(), seed, device=resolve_device(device))
        return params if self.mesh is None else shard(params, self.specs(), self.mesh)

    def abstract(self) -> dict[str, Any]:
        """The parameters as empty ``meta`` tensors (a dry run's input);
        under a mesh, this rank's shards."""
        params = abstract(self.decls())
        return params if self.mesh is None else shard(params, self.specs(), self.mesh)

    def specs(self):
        """The placement of every parameter (``param.specs``)."""
        return specs(self.decls())

    def param_count(self) -> int:
        return param_count(self.decls())

    def _par(self, *, seq: bool = False, batch: bool = True) -> Par:
        return Par(self.rules, seq=seq, batch=batch)

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
    def _embed_in(self, params, batch, par: Par):
        if self.cfg.embeddings_in:
            return batch["embeddings"].to(self.cfg.dtype)
        return embed(params["embedding"], batch["tokens"], par, self.cfg.d_model)

    def _images(self, batch):
        return batch["images"].to(self.cfg.dtype) if self.cfg.family == "vlm" else None

    def _block(self, layer, x, positions, par: Par, collect_cache=False):
        if self.cfg.family in _SSM_BLOCKS:
            return B.ssm_block_forward(layer, x, self.cfg, collect_cache=collect_cache, par=par)
        return B.decoder_block_forward(layer, x, positions, self.cfg,
                                       collect_cache=collect_cache, rules=self.rules, par=par)

    def _shared_attn(self, params, x, positions, par: Par, return_kv=False):
        """The hybrid's shared attention block (pre-norm residual)."""
        h = rmsnorm(params["ln"], x, self.cfg.norm_eps, par)
        if return_kv:
            o, kv = gqa_forward(params["attn"], h, positions, self.cfg, return_kv=True, par=par)
            return x + o, kv
        return x + gqa_forward(params["attn"], h, positions, self.cfg, par=par)

    def _cross(self, params, x, img, par: Par):
        return B.cross_block_forward(params, x, image_kv(params["xattn"], img), self.cfg,
                                     par=par)

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (b, s, d), aux_loss).  With ``cfg.remat`` and grad
        mode on, each layer (and each shared attention or cross block) keeps
        only its input and runs its forward again in the backward (its
        collectives too, in the same order on every rank).  Under a mesh the
        hidden states are this rank's batch, whole over the model axis."""
        cfg = self.cfg
        par = self._par(seq=cfg.seq_parallel)
        x = self._embed_in(params, batch, par)
        img = self._images(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        if par.seq:
            if x.shape[1] % par.m_size:
                raise ValueError(f"seq_parallel: the sequence {x.shape[1]} is not divisible by "
                                 f"the model axis {par.m_size}")
            x = par.split(x, 1)

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        auxs = []
        blocks = layer_list(params["blocks"])
        cross = layer_list(params["cross_blocks"]) if "cross_blocks" in params else []
        for kind, i in self.schedule():
            if kind == "block":
                x, aux = run(self._block, blocks[i], x, positions, par)
                auxs.append(aux)
            elif kind == "attn":
                x = run(self._shared_attn, params["shared_attn"], x, positions, par)
            else:
                x = run(self._cross, cross[i], x, img, par)
        x = self._finish(params, x, par)
        if par.seq:
            x = par.gather_rep(x, 1)
        return x, torch.mean(torch.stack(auxs))

    def prefill(self, params, batch):
        """Returns (last-token logits (b, vocab_padded), cache).  The cache's
        ``layers`` leaves are stacked over the blocks: ``k``/``v`` (n, b, s,
        kv, hd), MLA's ``c``/``kr``, or the SSM's ``ssm`` (n, b, h, p, n_state)
        in fp32 and ``conv`` (n, b, w-1, ch); the hybrid adds ``attn_k`` /
        ``attn_v`` (n_groups, b, s, kv, hd), the VLM ``img_k`` / ``img_v``
        (n_cross, b, n_image_tokens, kv, hd).  Under a mesh: this rank's
        batch, the logits whole, each cache leaf this rank's shard as
        ``launch.specs.cache_pspecs`` places it."""
        par = self._par()
        x = self._embed_in(params, batch, par)
        img = self._images(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        layers, extra = [], {}
        for kind, i in self.schedule():
            if kind == "block":
                x, _, cache = self._block(layer_slice(params["blocks"], i), x, positions, par,
                                          collect_cache=True)
                layers.append(cache)
            elif kind == "attn":
                x, (k, v) = self._shared_attn(params["shared_attn"], x, positions, par,
                                              return_kv=True)
                extra.setdefault("attn_k", []).append(k)
                extra.setdefault("attn_v", []).append(v)
            else:
                cp = layer_slice(params["cross_blocks"], i)
                k, v = image_kv(cp["xattn"], img)
                x = B.cross_block_forward(cp, x, (k, v), self.cfg, par=par)
                extra.setdefault("img_k", []).append(k)
                extra.setdefault("img_v", []).append(v)
        cache = {"layers": _stack(layers), **{k: torch.stack(v) for k, v in extra.items()}}
        return self._last_logits(params, x, par), cache

    def _last_logits(self, params, x, par: Par | None = None):
        return self._decode_logits(params, x[:, -1:, :], par)

    def _finish(self, params, x, par: Par | None = None):
        return rmsnorm(params["ln_f"], x, self.cfg.norm_eps, par)

    def logits(self, params, hidden, par: Par | None = None):
        """Logits; under a mesh, this rank's shard of the vocabulary where
        the model axis divides it."""
        return unembed(params["embedding"], hidden, par, self.cfg.vocab_padded)

    # ------------------------------------------------------------------
    # training loss: CE + MoE aux + the paper's FDA MMD head
    # ------------------------------------------------------------------
    def loss(self, params, batch, n_clients: int = 1):
        """Returns (total, {"ce", "aux", "mmd"}): the mean next-token CE plus
        0.01 aux plus, with more than one client, ``fda_lambda`` times the
        FDA head's MMD (the batch laid out as (n_clients, per_client, ...)).
        Under a mesh every term is the global one, on every rank; each
        rank's gradient is its batch's part (``launch.train`` sums them over
        the data axes)."""
        cfg = self.cfg
        par = self._par()
        hidden, aux = self.forward(params, batch)
        logits = self.logits(params, hidden, par)
        ce_par = par if par.shards(cfg.vocab_padded) else None
        ce = par.data_mean(cross_entropy(logits, batch["labels"], cfg.vocab_size,
                                         sharded=cfg.sharded_ce, par=ce_par))
        total = ce + 0.01 * aux
        mmd = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if cfg.fda_lambda and n_clients > 1:
            mmd = fda_loss(params["fda"], hidden, n_clients, par)
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

    def cache_specs(self):
        """The reference's ``LM.cache_specs``: every leaf's batch dimension
        over the data axes (``launch.specs.cache_pspecs`` gives the
        placements the dry run and :meth:`decode_step` use)."""
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict)
                    else (None, self.rules.batch, *([None] * (len(v) - 2)))
                    for k, v in tree.items()}

        return walk(self.cache_shapes(1, 1))

    def cache_placements(self, batch: int, s_cache: int):
        """The placement of every cache leaf for a global ``batch``
        (``launch.specs.cache_pspecs``)."""
        from repro_torch.launch.specs import cache_placements

        return cache_placements(self, batch, s_cache, self.rules)

    def _cache_tree(self, batch: int, s_cache: int, maker):
        """``maker(shape, dtype)`` of every leaf: under a mesh, of this
        rank's shard of a cache for the global ``batch``."""
        placed = self.cache_placements(batch, s_cache) if self.mesh is not None else None

        def walk(tree, where):
            return {k: walk(v, where and where[k]) if isinstance(v, dict) else maker(
                v if where is None else local_shape(v, where[k], self.mesh),
                dtype=torch.float32 if k == "ssm" else self.cfg.dtype)
                for k, v in tree.items()}

        return walk(self.cache_shapes(batch, s_cache), placed)

    def init_cache(self, batch: int, s_cache: int, *, device=None):
        """Zeros of ``cache_shapes``: the SSM state in fp32, the rest in
        ``cfg.dtype``; under a mesh, this rank's shards (``batch`` global)."""
        dev = resolve_device(device)
        return self._cache_tree(batch, s_cache,
                                lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev))

    def abstract_cache(self, batch: int, s_cache: int):
        """``init_cache``'s tree as empty ``meta`` tensors."""
        return self._cache_tree(batch, s_cache,
                                lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                                 device="meta"))

    def decode_step(self, params, cache, batch, pos: int, *, global_batch: int | None = None):
        """One token for the whole stack. batch: tokens (b, 1), or embeddings
        (b, 1, d) for ``embeddings_in``; the VLM reads its image K/V from the
        cache.  pos: the position (the same across the batch).  Returns
        (logits (b, vocab_padded), cache); the cache is updated in place.

        Under a mesh the cache is placed as ``init_cache`` places it for the
        ``global_batch`` (``None``: a batch the data axes divide): the batch
        over the data axes, or, where they do not divide it, the same tokens
        on every data rank and the attention caches' sequence over them."""
        cfg = self.cfg
        par = self._par()
        if global_batch is not None and par.d_size > 1 and global_batch % par.d_size:
            par = self._par(batch=False)
        x = self._embed_in(params, batch, par)
        layers = cache["layers"]
        pos = int(pos)
        for kind, i in self.schedule():
            if kind == "block":
                layer, lc = layer_slice(params["blocks"], i), layer_slice(layers, i)
                if cfg.family in _SSM_BLOCKS:
                    x, _ = B.ssm_block_decode(layer, x, lc, cfg, par=par)
                else:
                    x, _ = B.decoder_block_decode(layer, x, lc, pos, cfg, par=par)
            elif kind == "attn":
                sp = params["shared_attn"]
                h = rmsnorm(sp["ln"], x, cfg.norm_eps)
                o, _, _ = gqa_decode(sp["attn"], h, cache["attn_k"][i], cache["attn_v"][i], pos,
                                     cfg, par=par)
                x = x + o
            else:
                x = B.cross_block_forward(layer_slice(params["cross_blocks"], i), x,
                                          (cache["img_k"][i], cache["img_v"][i]), cfg, par=par)
        return self._decode_logits(params, x, par), cache

    def _decode_logits(self, params, x, par: Par | None = None):
        """The logits of x (b, 1, d), whole over the model axis."""
        x = self._finish(params, x)
        logits = self.logits(params, x, par)
        if par is not None and par.shards(self.cfg.vocab_padded):
            logits = par.model_gather(logits, -1)
        return logits[:, 0, :]
