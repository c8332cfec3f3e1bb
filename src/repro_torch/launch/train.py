"""Training driver: any arch (full or reduced) on one CUDA card.

Port of ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 30 --batch 8 --seq 2048 --clients 2

``--reduced`` trains the smoke-scale variant (remat off, as in the
reference); ``--device cpu`` runs the plain PyTorch versions instead of the
kernels.  The FDA MMD head is active whenever more than one client shares
the batch.  Attention's forward and backward are K11 and K11b.  As in the
reference, an ``embeddings_in`` (audio) model trains on frame embeddings
(normal x 0.02, a CPU generator seeded by the step) against the stream's
labels, and the VLM on zero images.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import axis_size, data_axis_size, make_host_mesh
from repro_torch.models import LM, ShardRules
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm, cosine_schedule
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


def build_train_step(model: LM, opt, n_clients: int):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's value and gradient, clipping to a global norm of 1, one
    optimizer update.  A leaf the loss does not reach (the FDA head's
    frozen Omega) gets a zero gradient."""

    def train_step(params, opt_state, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.loss(live, batch, n_clients)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten_like(live, [torch.zeros_like(p) if g is None else g
                                           for p, g in zip(leaves, grads)])
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, "loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for the tests")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), remat=False)
    mesh = make_host_mesh(device=dev)
    rules = ShardRules(model_size=axis_size(mesh, "model"), batch_axes=("data",))
    model = LM(cfg, rules)
    n_clients = args.clients or max(2, data_axis_size(mesh))
    if args.batch % n_clients:
        n_clients = 1

    params = model.init(0, device=dev)
    opt = adamw(cosine_schedule(args.lr, warmup=10, total=args.steps), weight_decay=0.01)
    opt_state = opt.init(params)
    start_step = 0
    if args.ckpt:
        latest = ckpt_lib.latest_step(args.ckpt)
        if latest is not None:
            params = ckpt_lib.restore(args.ckpt, params)
            start_step = latest
            print(f"restored step {start_step} from {args.ckpt}")

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=1)
    step_fn = build_train_step(model, opt, n_clients)

    losses, grad_norms = [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        if cfg.embeddings_in:
            emb = torch.randn((args.batch, args.seq, cfg.d_model),
                              generator=torch.Generator().manual_seed(step)) * 0.02
            batch = {"embeddings": emb, "labels": batch["labels"]}
        if cfg.family == "vlm":
            batch["images"] = torch.zeros((args.batch, cfg.n_image_tokens, cfg.d_image))
        batch = {k: v.to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            toks = args.batch * args.seq / dt
            print(
                f"step {step+1}: loss={losses[-1]:.4f} ce={float(metrics['ce']):.4f} "
                f"mmd={float(metrics['mmd']):.5f} gnorm={float(metrics['grad_norm']):.2f} "
                f"{toks:,.0f} tok/s"
            )
            t0 = time.time()
        if args.ckpt and (step + 1) % 100 == 0:
            ckpt_lib.save(args.ckpt, params, step=step + 1)
    if args.ckpt:
        ckpt_lib.save(args.ckpt, params, step=args.steps)
    first = float(np.mean(losses[:10])) if len(losses) >= 10 else losses[0]
    last = float(np.mean(losses[-10:]))
    print(f"loss: first10={first:.4f} last10={last:.4f} (improved={last < first})")
    return {"first": first, "last": last, "losses": losses, "grad_norms": grad_norms}


if __name__ == "__main__":
    main()
