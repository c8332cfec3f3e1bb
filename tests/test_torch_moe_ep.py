"""Port parity: the expert-parallel MoE (repro_torch.models.moe.moe_forward_ep)
against repro's on the CPU.

The reference's ``moe_forward_ep`` (a ``shard_map`` over a (data 2, model 2)
mesh) runs in a subprocess with four forced CPU devices (the XLA device
count is fixed at jax's first import), its outputs read whole.  The port
runs in four processes, one (data, model) rank each of a gloo group on a
file store, over ``launch.mesh.make_host_mesh(model=2)``: each rank holds its
data shard of the batch and routes it to its two of the four experts.  The
same numpy parameters and inputs go to both.  Tolerances are those of
tests/test_torch_moe.py for ``moe_forward``: y and aux within 2e-5 at fp32,
y within 3e-2 of max(1, max|y|) at bf16 (aux 2e-5: it is fp32 in both).

Both sides also take the gradient of one scalar of y and aux (a fixed
weighting of y plus 3 aux): ``jax.grad`` through the reference's
``shard_map``, autograd through the port's collectives on each rank.  The
port's rank holds its part of each gradient: x's for its data shard, the
router's and the shared expert's for its tokens (summed here over the data
axis), the expert stacks' for its experts and tokens (summed over both
axes).  Each leaf is held to 1e-5 x max(1, max|leaf|) at fp32 and to the
bf16 rule above.  (With ``torch.distributed.nn``'s all-reduce, whose
backward all-reduces again, every upstream gradient came out twice too
large at a model axis of 2.)  At one rank, ``moe_forward_ep`` is
``moe_forward`` bit for bit, alone and as an ``LM``'s MoE blocks under
``cfg.moe_ep``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LM, ShardRules  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS, DATA, MODEL = 4, 2, 2
F32_TOL, BF16_RTOL, GRAD_RTOL = 2e-5, 3e-2, 1e-5
AUX_WEIGHT = 3.0
GRAD_LEAVES = ("x", "router", "gate", "up", "down", "shared/gate", "shared/up", "shared/down")
TIMEOUT_S = 240
SIZES = dict(arch_id="moe-ep", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=32, vocab_size=128, n_experts=4, top_k=2, n_shared_experts=1)
B, S = 4, 8  # the global batch: B / DATA sequences a data shard


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's small tensors and host linear algebra
    (torch's pool; OpenBLAS and OpenMP through threadpoolctl where it is
    installed): the suite runs in parallel workers, where each one's pools
    would contend for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(limits=1):
            yield
    torch.set_num_threads(before)


def _inputs(seed: int = 0) -> dict:
    """The MoE's weights (router, experts, one shared expert) and the global
    batch, numpy fp32 from ``seed``."""
    rng = np.random.default_rng(seed)
    d, f, e = SIZES["d_model"], SIZES["d_ff"], SIZES["n_experts"]

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    return {"router": w(d, e), "gate": w(e, d, f), "up": w(e, d, f), "down": w(e, f, d),
            "shared/gate": w(d, f), "shared/up": w(d, f), "shared/down": w(f, d),
            "x": rng.normal(size=(B, S, d)).astype(np.float32),
            "wy": rng.normal(size=(B, S, d)).astype(np.float32)}


REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs.base import ModelConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models import ShardRules
    from repro.models.moe import moe_forward, moe_forward_ep

    src, out_path, sizes = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    inp = dict(np.load(src))
    mesh = make_host_mesh(model=2)
    assert dict(mesh.shape) == {"data": 2, "model": 2}, mesh.shape
    rules = ShardRules(model_size=2, batch_axes=("data",), mesh=mesh)
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        cfg = ModelConfig(**sizes, dtype=dtype)
        params = {k: jnp.asarray(inp[k], jnp.float32 if k == "router" else dtype)
                  for k in ("router", "gate", "up", "down")}
        params["shared"] = {k: jnp.asarray(inp["shared/" + k], dtype)
                            for k in ("gate", "up", "down")}
        x = jnp.asarray(inp["x"], dtype)
        y, aux = moe_forward_ep(params, x, cfg, rules)
        out[name + "/y"] = np.asarray(jnp.asarray(y, jnp.float32))
        out[name + "/aux"] = np.asarray(aux, np.float32)
        wy = jnp.asarray(inp["wy"])

        def scalar(params, x):
            y, aux = moe_forward_ep(params, x, cfg, rules)
            return jnp.sum(y.astype(jnp.float32) * wy) + AUX_WEIGHT * aux

        gp, gx = jax.jit(jax.grad(scalar, argnums=(0, 1)))(params, x)
        grads = {"x": gx, **{k: gp[k] for k in ("router", "gate", "up", "down")},
                 **{"shared/" + k: gp["shared"][k] for k in ("gate", "up", "down")}}
        for k, g in grads.items():
            out[name + "/g/" + k] = np.asarray(jnp.asarray(g, jnp.float32))
    np.savez(out_path, **out)
    ''').replace("AUX_WEIGHT", repr(AUX_WEIGHT))

# one (data, model) rank of the port's expert-parallel MoE on a file store
PORT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ShardRules
    from repro_torch.models.moe import moe_forward_ep

    src, store, out_path, rank, sizes = (sys.argv[1], sys.argv[2], sys.argv[3],
                                         int(sys.argv[4]), eval(sys.argv[5]))
    inp = dict(np.load(src))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    try:
        mesh = make_host_mesh(model=2)
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 2)
        data_idx = mesh.get_local_rank("data")
        rules = ShardRules(model_size=2, batch_axes=("data",), mesh=mesh)
        b_loc = inp["x"].shape[0] // 2
        out = {"data_idx": np.int64(data_idx)}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            cfg = ModelConfig(**sizes, dtype=dtype)
            params = {k: torch.tensor(inp[k]).to(torch.float32 if k == "router" else dtype)
                      for k in ("router", "gate", "up", "down")}
            params["shared"] = {k: torch.tensor(inp["shared/" + k]).to(dtype)
                                for k in ("gate", "up", "down")}
            x = torch.tensor(inp["x"][data_idx * b_loc:(data_idx + 1) * b_loc]).to(dtype)
            leaves = {"x": x, **{k: params[k] for k in ("router", "gate", "up", "down")},
                      **{"shared/" + k: params["shared"][k] for k in ("gate", "up", "down")}}
            for t in leaves.values():
                t.requires_grad_()
            y, aux = moe_forward_ep(params, x, cfg, rules)
            out[name + "/y"] = y.detach().float().numpy()
            out[name + "/aux"] = aux.detach().float().numpy()
            wy = torch.tensor(inp["wy"][data_idx * b_loc:(data_idx + 1) * b_loc])
            scalar = torch.sum(y.float() * wy) + AUX_WEIGHT * aux
            grads = dict(zip(leaves, torch.autograd.grad(scalar, list(leaves.values()))))
            for k, g in grads.items():
                g = g.detach().float()
                if k != "x":  # each rank's part: its tokens (and its experts)
                    dist.all_reduce(g, group=mesh.get_group("data"))
                if k in ("gate", "up", "down"):
                    dist.all_reduce(g, group=mesh.get_group("model"))
                out[name + "/g/" + k] = g.numpy()
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
    ''').replace("AUX_WEIGHT", repr(AUX_WEIGHT))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference on four forced devices and the port on four gloo
    ranks, once for the module: (reference outputs, each rank's)."""
    tmp_path = tmp_path_factory.mktemp("moe_ep")
    src = tmp_path / "inputs.npz"
    np.savez(src, **_inputs())
    ref_path = tmp_path / "ref.npz"
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(src), str(ref_path),
                               repr(SIZES)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env())]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(src), str(tmp_path / "store"),
                                str(tmp_path / f"rank{r}.npz"), str(r), repr(SIZES)],
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
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-2000:] for e in errs)
    return (dict(np.load(ref_path)),
            [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)])


def test_expert_parallel_matches_reference_on_four_gloo_ranks(four_ranks):
    ref, ranks = four_ranks
    b_loc = B // DATA
    for r, out in enumerate(ranks):
        i = int(out["data_idx"])
        assert i == r // MODEL
        want = ref["f32/y"][i * b_loc:(i + 1) * b_loc]
        np.testing.assert_allclose(out["f32/y"], want, rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(out["f32/aux"], ref["f32/aux"], rtol=0, atol=F32_TOL)
        want = ref["bf16/y"][i * b_loc:(i + 1) * b_loc]
        assert np.abs(out["bf16/y"] - want).max() <= BF16_RTOL * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(out["bf16/aux"], ref["bf16/aux"], rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_expert_parallel_gradient_matches_reference_on_four_gloo_ranks(four_ranks, leaf):
    """``jax.grad`` through the reference's ``shard_map`` (step 0) against
    autograd through the port's collectives, every rank."""
    ref, ranks = four_ranks
    b_loc = B // DATA
    for name, rtol in (("f32", GRAD_RTOL), ("bf16", BF16_RTOL)):
        want = ref[f"{name}/g/{leaf}"]
        for r, out in enumerate(ranks):
            if leaf == "x":
                i = int(out["data_idx"])
                want_r = want[i * b_loc:(i + 1) * b_loc]
            else:
                want_r = want
            got = out[f"{name}/g/{leaf}"]
            err = np.abs(got - want_r).max() / max(1.0, np.abs(want_r).max())
            assert err <= rtol, (name, leaf, r, err)


def _params(dtype) -> tuple[dict, torch.Tensor]:
    inp = _inputs(1)
    params = {k: torch.tensor(inp[k]).to(torch.float32 if k == "router" else dtype)
              for k in ("router", "gate", "up", "down")}
    params["shared"] = {k: torch.tensor(inp["shared/" + k]).to(dtype)
                        for k in ("gate", "up", "down")}
    return params, torch.tensor(inp["x"]).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
def test_one_rank_is_moe_forward_bit_for_bit(dtype, capacity_factor):
    """With no process group the host mesh is 1 x 1 and no collective runs."""
    cfg = ModelConfig(**SIZES, dtype=dtype, capacity_factor=capacity_factor)
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    params, x = _params(dtype)
    y, aux = tmoe.moe_forward_ep(params, x, cfg, ShardRules(model_size=1, mesh=mesh))
    y0, aux0 = tmoe.moe_forward(params, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_lm_runs_its_moe_blocks_expert_parallel_under_moe_ep(monkeypatch):
    """``LM(cfg, rules)`` with a mesh and ``cfg.moe_ep`` routes every MoE
    block through ``moe_forward_ep``: at one rank, the same hidden states and
    aux as the plain ``LM`` bit for bit."""
    cfg = dataclasses.replace(ModelConfig(**SIZES, dtype=torch.float32), moe_ep=True,
                              remat=False)
    rules = ShardRules(model_size=1, mesh=make_host_mesh(device="cpu"))
    calls = []
    real = tmoe.moe_forward_ep
    monkeypatch.setattr(tmoe, "moe_forward_ep", lambda *a: calls.append(1) or real(*a))
    ep, plain = LM(cfg, rules), LM(dataclasses.replace(cfg, moe_ep=False))
    params = plain.init(0, device="cpu")
    toks = torch.arange(2 * S).reshape(2, S) % SIZES["vocab_size"]
    h, aux = ep.forward(params, {"tokens": toks})
    h0, aux0 = plain.forward(params, {"tokens": toks})
    assert len(calls) == SIZES["n_layers"]
    assert torch.equal(h, h0) and torch.equal(aux, aux0)
    assert LM(cfg).rules.mesh is None  # no rules: the plain MoE, as the reference
