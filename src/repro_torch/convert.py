"""Carry reference states into the port: an ``RFTCAState`` (and its fit
statistics), the FedRF-TCA client parameters of a trainer, and the LM
backbone's parameter tree.

The reference's fields arrive as numpy arrays (or ``None`` and plain
tuples); nothing of the reference package is imported here.  With these, a
state fitted by ``repro`` transforms and re-solves in ``repro_torch``, and a
trainer starts from the reference's initial parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rf_tca import RFTCAState
from repro_torch.device import as_f32, resolve_device


def state_from_reference(omega, w_rf, eigvals, fused, *, device=None) -> RFTCAState:
    """The port's :class:`RFTCAState` from a reference state's fields.

    ``omega`` is ``None`` on the seed-fused path; ``fused`` is the reference's
    ``(seed, ensemble, sigma, kernel)`` spec or ``None``.
    """
    dev = resolve_device(device)
    spec = None
    if fused is not None:
        seed, ensemble, sigma, kernel = fused
        spec = (int(seed), int(ensemble), float(sigma), str(kernel))
    return RFTCAState(
        omega=None if omega is None else as_f32(np.asarray(omega), dev),
        w_rf=as_f32(np.asarray(w_rf), dev),
        eigvals=as_f32(np.asarray(eigvals), dev),
        fused=spec,
    )


def stats_from_reference(stats: dict, *, device=None) -> dict:
    """The retained statistics of ``rf_tca_fit_with_stats`` (``gram`` = G_H,
    ``u``, and the solve's ``gamma``, ``m``, ``solver``, ``seed``) on the
    port's device, ready for ``repro_torch.core.rf_tca.rf_tca_resolve``."""
    dev = resolve_device(device)
    return {
        "gram": as_f32(np.asarray(stats["gram"]), dev),
        "u": as_f32(np.asarray(stats["u"]), dev),
        "gamma": float(stats["gamma"]),
        "m": int(stats["m"]),
        "solver": str(stats["solver"]),
        "seed": int(stats["seed"]),
    }


def params_from_reference(tree, *, device=None) -> dict:
    """The port's FedRF-TCA parameter tree from the reference's
    (``extractor[i].{w,b}``, ``w_rf``, ``classifier.{w,b}``, numpy leaves)."""
    dev = resolve_device(device)
    return {
        "extractor": [{"w": as_f32(np.asarray(layer["w"]), dev),
                       "b": as_f32(np.asarray(layer["b"]), dev)} for layer in tree["extractor"]],
        "w_rf": as_f32(np.asarray(tree["w_rf"]), dev),
        "classifier": {"w": as_f32(np.asarray(tree["classifier"]["w"]), dev),
                       "b": as_f32(np.asarray(tree["classifier"]["b"]), dev)},
    }


def load_reference_params(trainer, tree) -> None:
    """Start ``trainer`` (a ``federated.FedRFTCATrainer`` built with
    ``warmup_rounds=0``) from the reference's shared initial parameters:
    every client, the target and the W_RF init take them, and every Adam
    state is reset.  A frozen-W (seed-replay) trainer is refused: its W_RF is
    the port's own seed-derived draw."""
    from repro_torch.utils.tree import stack_trees, tree_map

    if trainer.proto.warmup_rounds:
        raise ValueError("load_reference_params needs a trainer built with warmup_rounds=0")
    if trainer._frozen_w:
        raise ValueError("a seed_replay trainer keeps the W_RF of its own seed")
    params = params_from_reference(tree, device=trainer.device)
    clients = [tree_map(torch.clone, params) for _ in range(trainer.k)]
    trainer.tgt_params = tree_map(torch.clone, params)
    trainer.tgt_opt = trainer.opt.init(trainer.tgt_params)
    trainer._w_init = params["w_rf"]
    if trainer._engine is not None:
        trainer._src_stack = stack_trees(clients)
        trainer._src_opt_stack = stack_trees([trainer.opt.init(p) for p in clients])
    else:
        trainer.src_params = clients
        trainer.src_opt = [trainer.opt.init(p) for p in clients]


def lm_params_from_reference(tree, cfg, *, device=None) -> dict:
    """The port's ``models.LM`` parameter tree from the reference's
    ``LM.init`` tree (nested dicts of numpy leaves), leaf for leaf, each in
    the dtype its declaration gives (``cfg.dtype``; fp32 for the FDA head,
    the MoE router and the SSM's ``dt_bias``, ``a_log`` and ``d_skip``), 0-d
    leaves (the VLM's stacked cross-attention gates) included.

    JAX's bf16 leaves arrive as ``ml_dtypes.bfloat16``, which ``torch`` does
    not read: they go through float32, and bf16 -> f32 -> bf16 is exact."""
    from repro_torch.models import LM
    from repro_torch.models.param import ParamDecl

    dev = resolve_device(device)

    def walk(decl, leaf, path):
        if isinstance(decl, ParamDecl):
            arr = np.asarray(leaf).astype(np.float32)
            if arr.shape != decl.shape:
                raise ValueError(f"{path}: reference shape {arr.shape}, port {decl.shape}")
            return torch.from_numpy(arr).to(device=dev, dtype=decl.dtype)
        if set(decl) != set(leaf):
            raise ValueError(f"{path}: reference keys {sorted(leaf)}, port {sorted(decl)}")
        return {k: walk(decl[k], leaf[k], f"{path}.{k}") for k in decl}

    return walk(LM(cfg).decls(), tree, "params")
