"""Language-model assembly: the decoder families' training and serve paths.

Port of ``repro.models.model`` for ``family`` ``"dense"`` and ``"moe"``, each
with GQA or MLA attention.  One :class:`LM` wraps a ModelConfig and provides

  decls / init / param_count          — parameter machinery (see param.py)
  forward(params, batch)              — hidden states (training / prefill)
  loss(params, batch, n_clients)      — CE + aux + the FDA MMD head
  prefill(params, batch)              — last-token logits + the KV cache
  decode_step(params, cache, batch)   — one-token serve step with the cache
  cache_shapes / init_cache           — cache trees (K/V, or MLA's c/kr)

The reference's stacked layer axis is kept (``blocks.*`` leaves are
``(n_layers, ...)``, so weights convert leaf for leaf); a Python loop over
it replaces ``lax.scan``, and with ``cfg.remat`` each layer is checkpointed
(``torch.utils.checkpoint``) where the reference wraps its scanned body in
``jax.checkpoint``.  Every other family raises ``NotImplementedError``
naming its ROADMAP step.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.fda_head import fda_decl, fda_loss
from repro_torch.models.layers import (
    cross_entropy,
    embed,
    embedding_decl,
    rmsnorm,
    rmsnorm_decl,
    unembed,
)
from repro_torch.models.param import materialize, param_count, stack_decls

_LATER_FAMILIES = {
    "ssm": "step 13e",
    "hybrid": "step 13f",
    "vlm": "step 13g",
    "audio": "step 13h",
}


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree stacked over the layers (views, not copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family in _LATER_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: ROADMAP queue 1, {_LATER_FAMILIES[cfg.family]}")
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"unknown family {cfg.family}")
        if cfg.embeddings_in:
            raise NotImplementedError("embeddings in (audio): ROADMAP queue 1, step 13h")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameter declarations
    # ------------------------------------------------------------------
    def decls(self) -> dict:
        cfg = self.cfg
        return {
            "embedding": embedding_decl(cfg),
            "ln_f": rmsnorm_decl(cfg.d_model, cfg.dtype),
            "fda": fda_decl(cfg),
            "blocks": stack_decls(B.decoder_block_decl(cfg), cfg.n_layers),
        }

    def init(self, seed: int | torch.Generator = 0, *, device=None) -> dict[str, Any]:
        """Parameters drawn from ``seed`` (see ``param.materialize``) on
        ``device`` (``None``: the CUDA card)."""
        return materialize(self.decls(), seed, device=resolve_device(device))

    def param_count(self) -> int:
        return param_count(self.decls())

    # ------------------------------------------------------------------
    # forward (prefill)
    # ------------------------------------------------------------------
    def _embed_in(self, params, batch):
        return embed(params["embedding"], batch["tokens"])

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (b, s, d), aux_loss).  With ``cfg.remat`` and grad
        mode on, each layer keeps only its input and runs its forward again
        in the backward."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        auxs = []
        for i in range(cfg.n_layers):
            layer = layer_slice(params["blocks"], i)
            if remat:
                x, aux = checkpoint(B.decoder_block_forward, layer, x, positions, cfg,
                                    use_reentrant=False)
            else:
                x, aux = B.decoder_block_forward(layer, x, positions, cfg)
            auxs.append(aux)
        return self._finish(params, x), torch.mean(torch.stack(auxs))

    def prefill(self, params, batch):
        """Returns (last-token logits (b, vocab_padded), cache) with the cache
        leaves stacked over the layers: ``{"layers": {"k", "v"}}``, each
        (n_layers, b, s, kv, hd), or MLA's ``{"layers": {"c", "kr"}}``,
        (n_layers, b, s, r) and (n_layers, b, s, rope_head_dim)."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        layers: dict[str, list] = {}
        for i in range(cfg.n_layers):
            x, _, cache = B.decoder_block_forward(layer_slice(params["blocks"], i), x, positions,
                                                  cfg, collect_cache=True)
            for key, leaf in cache.items():
                layers.setdefault(key, []).append(leaf)
        return self._last_logits(params, x), {
            "layers": {key: torch.stack(leaves) for key, leaves in layers.items()}}

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
        per = B.decoder_cache_decl(cfg, batch, s_cache)
        return {"layers": {k: (cfg.n_layers, *v) for k, v in per.items()}}

    def init_cache(self, batch: int, s_cache: int, *, device=None):
        dev = resolve_device(device)
        return {"layers": {k: torch.zeros(v, dtype=self.cfg.dtype, device=dev)
                           for k, v in self.cache_shapes(batch, s_cache)["layers"].items()}}

    def decode_step(self, params, cache, batch, pos: int):
        """One token for the whole stack. batch: tokens (b, 1). pos: the
        position (the same across the batch).  Returns (logits (b,
        vocab_padded), cache); the cache is updated in place."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            x, _ = B.decoder_block_decode(layer_slice(params["blocks"], i), x,
                                          layer_slice(layers, i), int(pos), cfg)
        return self._decode_logits(params, x), cache

    def _decode_logits(self, params, x):
        x = self._finish(params, x)
        return self.logits(params, x)[:, 0, :]
