"""Shared machinery of the SPMD parity tests (tests/test_torch_spmd*.py; not a
test module): the port's LM on four gloo ranks, a (data 2, model 2) mesh,
against the reference's unsharded functions on the CPU.

A case names an architecture, overrides of its ``reduced()`` config and the
runs to make:

- ``loss``: ``LM.loss`` at n_clients 2 and every gradient leaf
  (``jax.value_and_grad`` on the reference's side; on the port's, each
  rank's gradient summed over the data axis, then ``param.unshard``);
- ``decode``: ``LM.prefill`` (last-token logits and every cache leaf), then
  one ``decode_step`` at position S on the cache grown by ``GROW`` slots;
- ``decode1``: the same at a batch of one, whose cache's sequence lies over
  the data axis on the port's side (prefilled unsharded, then placed);
- ``train``: one ``build_train_step`` (AdamW, clipping to 1).

The weights are the port's ``materialize`` of the whole tree at seed 0 (the
VLM's gates set to 0.5, so that its cross blocks are not identities), saved
as numpy; both sides load them, the reference into its own tree, each port
rank cut to its shards by ``param.shard``.  The reference runs in one
subprocess with four forced CPU devices (its ``moe_forward_ep`` needs a
mesh; its other functions run unsharded), under ``jax.jit``; the ranks in
four more, on a file store.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.utils.tree import tree_flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
RANKS, DATA, MODEL = 4, 2, 2
B, S, GROW, N_CLIENTS = 4, 16, 4, 2
TIMEOUT_S = 300
LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4  # x max(1, |loss|), x max(1, max|leaf|)
NUDGE = 1e-7  # the relative nudge of the weights whose movement the gradient gate adds
LR = 3e-4  # the train step's AdamW rate
VLM_GATE = 0.5


def case(name: str, arch: str, do=("loss", "decode"), ep: bool = False, **overrides) -> dict:
    return dict(name=name, arch=arch, do=tuple(do), ep=ep, overrides=overrides)


def config(c: dict):
    return dataclasses.replace(get_config(c["arch"]).reduced(), **c["overrides"])


def inputs(cases) -> dict:
    """Every case's whole weights and global batch, numpy fp32 (int64 tokens)."""
    out = {}
    for c in cases:
        cfg, n = config(c), c["name"]
        params = LM(cfg).init(0, device="cpu")
        if cfg.family == "vlm":
            params["cross_blocks"]["xattn"]["gate"].fill_(VLM_GATE)
        for path, leaf in zip(*tree_flatten_with_paths(params)):
            out[f"{n}/p/{path}"] = leaf.float().numpy()
        rng = np.random.default_rng(7)
        out[f"{n}/b/labels"] = rng.integers(0, cfg.vocab_size, (B, S))
        if cfg.embeddings_in:
            out[f"{n}/b/embeddings"] = rng.normal(size=(B, S + 1, cfg.d_model)).astype(np.float32)
        else:
            out[f"{n}/b/tokens"] = rng.integers(0, cfg.vocab_size, (B, S + 1))
        if cfg.family == "vlm":
            out[f"{n}/b/images"] = rng.normal(
                size=(B, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)
    return out


# shared by both sides: the batch of a case (the prompt is the first S
# positions, the decode token position S), and the cache grown by GROW slots
COMMON = textwrap.dedent('''
    B, S, GROW, N_CLIENTS, VLM_GATE = {B}, {S}, {GROW}, {N_CLIENTS}, {VLM_GATE}
    NUDGE, LR = {NUDGE}, {LR}
    SEQ_KEYS = ("k", "v", "attn_k", "attn_v", "c", "kr")

    def nested(flat, prefix):
        tree = {{}}
        for key, value in flat.items():
            if key.startswith(prefix):
                node = tree
                parts = key[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {{}})
                node[parts[-1]] = value
        return tree

    def batches(inp, name, rows=slice(None)):
        b = {{k[len(name) + 3:]: v[rows] for k, v in inp.items()
             if k.startswith(name + "/b/")}}
        seq = {{k: v for k, v in b.items() if k in ("tokens", "embeddings")}}
        train = {{k: v[:, :S] if k in seq else v for k, v in b.items()}}
        prompt = {{k: v for k, v in train.items() if k != "labels"}}
        token = {{k: v[:, S:S + 1] for k, v in seq.items()}}
        return train, prompt, token
    ''').format(B=B, S=S, GROW=GROW, N_CLIENTS=N_CLIENTS, VLM_GATE=VLM_GATE,
                 NUDGE=NUDGE, LR=LR)

REFERENCE = COMMON + textwrap.dedent('''
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import build_train_step
    from repro.models import LM, ShardRules
    from repro.optim import adamw

    src, out_path, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    inp = dict(np.load(src))
    out = {}

    def save(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[prefix + key] = np.asarray(leaf, np.float32)

    def grow(cache):
        def g(path, a):
            if str(getattr(path[-1], "key", "")) in SEQ_KEYS:
                pad = [(0, 0)] * a.ndim
                pad[2] = (0, GROW)
                return jnp.pad(a, pad)
            return a
        return jax.tree_util.tree_map_with_path(g, cache)

    for c in cases:
        n = c["name"]
        cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["overrides"])
        rules = ShardRules(model_size=2, mesh=make_host_mesh(model=2)) if c["ep"] else None
        model = LM(cfg, rules)
        params = jax.tree_util.tree_map(jnp.asarray, nested(inp, n + "/p/"))
        for do in c["do"]:
            rows = slice(0, 1) if do == "decode1" else slice(None)
            train, prompt, token = (jax.tree_util.tree_map(jnp.asarray, t)
                                    for t in batches(inp, n, rows))
            if do == "loss":
                (loss, met), grads = jax.jit(jax.value_and_grad(
                    lambda p: model.loss(p, train, N_CLIENTS), has_aux=True))(params)
                out[n + "/loss"] = np.float32(loss)
                for k, v in met.items():
                    out[n + "/m/" + k] = np.float32(v)
                save(n + "/g/", grads)
            elif do in ("decode", "decode1"):
                logits, cache = jax.jit(model.prefill)(params, prompt)
                out[f"{n}/{do}/prefill"] = np.asarray(logits, np.float32)
                save(f"{n}/{do}/cache/", cache)
                logits, cache = jax.jit(model.decode_step)(params, grow(cache), token, S)
                out[f"{n}/{do}/logits"] = np.asarray(logits, np.float32)
                save(f"{n}/{do}/cache2/", cache)
            elif do == "train":
                opt = adamw(LR, weight_decay=0.1)
                step = jax.jit(build_train_step(model, opt, N_CLIENTS))
                new, _, met = step(params, opt.init(params), train)
                for k, v in met.items():
                    out[n + "/train/m/" + k] = np.float32(v)
                save(n + "/train/p/", new)
    np.savez(out_path, **out)
    ''')

PORT = COMMON + textwrap.dedent('''
    import dataclasses, sys, warnings
    warnings.simplefilter("ignore")
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_train_step, sum_over_data
    from repro_torch.models import LM, ShardRules
    from repro_torch.models.param import shard, unshard
    from repro_torch.models.parallel import Par
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves, tree_map
    from repro_torch.utils.tree import tree_unflatten_like

    src, store, out_path, rank, cases = (sys.argv[1], sys.argv[2], sys.argv[3],
                                         int(sys.argv[4]), eval(sys.argv[5]))
    inp = dict(np.load(src))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    out = {}

    def save(prefix, tree):
        if rank == 0:
            for path, leaf in zip(*tree_flatten_with_paths(tree)):
                out[prefix + path] = leaf.detach().float().numpy()

    def torch_tree(tree):
        return tree_map(lambda a: torch.tensor(a), tree)

    def plain_grads(plain, whole, train):
        live = tree_map(lambda t: t.detach().requires_grad_(), whole)
        loss, _ = plain.loss(live, train, N_CLIENTS)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return tree_unflatten_like(live, [torch.zeros_like(p) if g is None else g
                                          for p, g in zip(leaves, grads)])

    def grow(cache, over_data):
        def g(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = g(v)
                elif k in SEQ_KEYS and not over_data:
                    out[k] = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 3) + (0, GROW))
                else:
                    out[k] = v
            return out
        return g(cache)

    try:
        mesh = make_host_mesh(model=2)
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 2)
        d_idx = mesh.get_local_rank("data")
        rows = slice(d_idx * B // 2, (d_idx + 1) * B // 2)
        for c in cases:
            n = c["name"]
            cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["overrides"])
            rules = ShardRules(model_size=2, mesh=mesh)
            model = LM(cfg, rules)
            whole = torch_tree(nested(inp, n + "/p/"))
            params = shard(whole, model.specs(), mesh)
            for do in c["do"]:
                if do == "decode1":
                    train, prompt, token = (torch_tree(t) for t in batches(inp, n, slice(0, 1)))
                else:
                    train, prompt, token = (torch_tree(t) for t in batches(inp, n, rows))
                if do == "loss":
                    live = tree_map(lambda t: t.detach().requires_grad_(), params)
                    loss, met = model.loss(live, train, N_CLIENTS)
                    leaves = tree_leaves(live)
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)]
                    grads = tree_unflatten_like(live, sum_over_data(grads, Par(rules)))
                    if rank == 0:
                        out[n + "/loss"] = np.float32(loss.item())
                        for k, v in met.items():
                            out[n + "/m/" + k] = np.float32(v.item())
                    save(n + "/g/", unshard(grads, model.specs(), mesh))
                    if rank == 0:  # the port unsharded, and what a 1e-7 nudge moves it
                        plain = LM(cfg)
                        train = torch_tree(batches(inp, n)[0])  # the whole batch
                        g0 = plain_grads(plain, whole, train)
                        gen = torch.Generator().manual_seed(1)
                        moved = plain_grads(plain, tree_map(
                            lambda t: t * (1 + NUDGE * torch.randn(t.shape, generator=gen)),
                            whole), train)
                        if not cfg.moe_ep:
                            save(n + "/g0/", g0)
                        for path, a, b in zip(*tree_flatten_with_paths(g0),
                                              tree_leaves(moved)):
                            out[n + "/nudge/" + path] = np.float32(
                                float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
                elif do == "decode":
                    with torch.no_grad():
                        logits, cache = model.prefill(params, prompt)
                        save(f"{n}/{do}/prefill", {"": unshard(logits, ("data", None), mesh)})
                        placed = model.cache_placements(B, S)
                        save(f"{n}/{do}/cache/", unshard(cache, placed, mesh))
                        logits, cache = model.decode_step(params, grow(cache, False), token, S)
                        save(f"{n}/{do}/logits", {"": unshard(logits, ("data", None), mesh)})
                        save(f"{n}/{do}/cache2/", unshard(cache, model.cache_placements(
                            B, S + GROW), mesh))
                elif do == "decode1":
                    # the prompt prefilled whole, then placed: the sequence over data
                    with torch.no_grad():
                        plain = LM(cfg)
                        logits, cache = plain.prefill(whole, prompt)
                        save(f"{n}/{do}/prefill", {"": logits})
                        save(f"{n}/{do}/cache/", cache)
                        cache = shard(grow(cache, False), model.cache_placements(1, S + GROW),
                                      mesh)
                        logits, cache = model.decode_step(params, cache, token, S,
                                                          global_batch=1)
                        save(f"{n}/{do}/logits", {"": logits})
                        save(f"{n}/{do}/cache2/", unshard(cache, model.cache_placements(
                            1, S + GROW), mesh))
                elif do == "train":
                    opt = adamw(LR, weight_decay=0.1)
                    step = build_train_step(model, opt, N_CLIENTS)
                    new, _, met = step(params, opt.init(params), train)
                    if rank == 0:
                        for k, v in met.items():
                            out[n + "/train/m/" + k] = np.float32(v.item())
                    save(n + "/train/p/", unshard(new, model.specs(), mesh))
                    if rank == 0:  # the port unsharded, on the whole batch
                        step = build_train_step(LM(cfg), opt, N_CLIENTS)
                        new, _, met = step(whole, opt.init(whole),
                                           torch_tree(batches(inp, n)[0]))
                        for k, v in met.items():
                            out[n + "/train0/m/" + k] = np.float32(v.item())
                        save(n + "/train0/p/", new)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
    ''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


def run(tmp_path: Path, cases) -> tuple[dict, dict]:
    """The reference and the four ranks on ``cases``, in parallel: (the
    reference's outputs, rank 0's)."""
    src = tmp_path / "inputs.npz"
    np.savez(src, **inputs(cases))
    wire = repr(cases)
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "port.npz"
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(src), str(ref_path), wire],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env())]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(src), str(tmp_path / "store"),
                                str(port_path), str(r), wire],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env=_env()) for r in range(RANKS)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return dict(np.load(ref_path)), dict(np.load(port_path))


def leaf_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max(1, max|want|)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def check(ref: dict, port: dict, prefix: str) -> None:
    """Every key of ``ref`` under ``prefix`` against ``port``'s: the loss by
    LOSS_RTOL, the rest by LEAF_RTOL."""
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys, prefix
    for k in keys:
        got, want = np.asarray(port[k]), np.asarray(ref[k])
        if k.endswith("/loss"):
            assert abs(float(got) - float(want)) <= LOSS_RTOL * max(1.0, abs(float(want))), k
        else:
            assert leaf_err(got, want) <= LEAF_RTOL, (k, leaf_err(got, want))


def check_grads(ref: dict, port: dict, name: str) -> None:
    """Every gradient leaf, against the port's unsharded gradient (not under
    ``moe_ep``, which has no unsharded form) and the reference's within
    LEAF_RTOL plus four times what a NUDGE of the weights moves the port's
    own unsharded gradient (tests/test_torch_train.py's rule: the
    random-init stack amplifies fp32 rounding, and the sharded sums round
    in another order); where the unsharded port itself is farther from the
    reference than that, no farther than it plus LEAF_RTOL."""
    prefix = f"{name}/g/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys, prefix
    for k in keys:
        path = k[len(prefix):]
        got = np.asarray(port[k])
        gate = LEAF_RTOL + 4 * float(port[f"{name}/nudge/{path}"])
        plain = port.get(f"{name}/g0/{path}")
        if plain is not None:
            assert leaf_err(got, plain) <= gate, (k, leaf_err(got, plain), gate)
            gate = max(gate, leaf_err(plain, ref[k]) + LEAF_RTOL)
        assert leaf_err(got, ref[k]) <= gate, (k, leaf_err(got, ref[k]), gate)


def check_train(ref: dict, port: dict, name: str) -> None:
    """One AdamW step, tests/test_torch_train.py's rule: the loss and metrics
    within LEAF_RTOL; the global norm within 1e-3 of itself (the
    embeddings' gradient dominates it, which a nudge moves by ~6e-4), or no
    farther than the unsharded port's plus LEAF_RTOL; each new parameter
    within LEAF_RTOL x max(1, max|leaf|) plus 2 lr (an element whose
    near-zero gradient the packages round to opposite signs moves by lr
    either way).  Against the port's unsharded step: the metrics within
    LEAF_RTOL, each parameter within LEAF_RTOL x max(1, max|leaf|)."""
    def rel(a, b):
        return abs(float(a) - float(b)) / max(1.0, abs(float(b)))

    for key in ("loss", "ce", "aux", "mmd", "grad_norm"):
        got, plain = port[f"{name}/train/m/{key}"], port[f"{name}/train0/m/{key}"]
        want = ref[f"{name}/train/m/{key}"]
        assert rel(got, plain) <= LEAF_RTOL, (key, got, plain)
        if key == "grad_norm":
            gate = max(1e-3, abs(float(plain) - float(want)) / float(want) + LEAF_RTOL)
            assert abs(float(got) - float(want)) <= gate * float(want), (got, want, gate)
        else:
            assert rel(got, want) <= LEAF_RTOL, (key, got, want)
    prefix = f"{name}/train/p/"
    for k in [k for k in ref if k.startswith(prefix)]:
        want, got = np.asarray(ref[k]), np.asarray(port[k])
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= LEAF_RTOL * scale + 2 * LR, (k, err)
        plain = np.asarray(port[f"{name}/train0/p/" + k[len(prefix):]])
        assert leaf_err(got, plain) <= LEAF_RTOL, (k, leaf_err(got, plain))


def one_thread():
    """One thread for the test process's small tensors (the suite runs in
    parallel workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
