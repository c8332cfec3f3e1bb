"""Shared checks of the port's LM families against repro on the CPU, for
tests/test_torch_ssm.py and tests/test_torch_vlm_audio.py (not a test module).

Every check runs the reference and the port on the same numpy inputs, the
port's weights carried over from the reference's ``LM.init`` tree by
``repro_torch.convert.lm_params_from_reference``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JConfig
from repro.launch.serve import grow_cache as jgrow_cache
from repro.models import LM as JLM
from repro.models import ShardRules
from repro.models.param import is_decl
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map

RULES = ShardRules(model_size=1)
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
# the VLM's cross-attention gate: tanh(0) = 0 at init would make every
# cross block an identity and hide the image path
VLM_GATE = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread for the module's small tensors and host linear algebra
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


def port_config(cfg: JConfig) -> ModelConfig:
    """The port's config with every field of the reference's."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = DTYPES[jnp.dtype(cfg.dtype)]
    return ModelConfig(**fields)


def mk(**kw) -> JConfig:
    """tests/test_models.py:17-24's tiny config."""
    base = dict(
        arch_id="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=97, head_dim=16, dtype=jnp.float32, fda_n_rff=16,
        fda_m=4, remat=False,
    )
    base.update(kw)
    return JConfig(**base)


def reduced(arch):
    """The architecture's ``reduced()`` config, with overrides."""
    return lambda **kw: dataclasses.replace(jget_config(arch).reduced(), **kw)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(a, b, atol, *, rel_to_max=False, what=""):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    tol = atol * max(1.0, float(np.abs(b).max())) if rel_to_max else atol
    err = float(np.abs(a - b).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"
    return err


def both(x: np.ndarray, dtype="f32"):
    """The same values as a jax array and a CPU torch tensor (bf16 rounds to
    nearest even in both)."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x, jnp.float32), torch.tensor(np.asarray(x, np.float32))


def leaves(tree) -> dict:
    """path -> leaf of a nested dict (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in leaves(v).items()})
        else:
            out[k] = v
    return out


def decls_match(ref: JConfig) -> None:
    """The port's decls: the reference's keys, shapes, inits, scales and
    dtypes, and its parameter count."""
    flat_j = {"/".join(str(p.key) for p in kp): d for kp, d in
              jax.tree_util.tree_flatten_with_path(JLM(ref, RULES).decls(), is_leaf=is_decl)[0]}
    flat_t = leaves(LM(port_config(ref)).decls())
    assert set(flat_j) == set(flat_t)
    for path, d in flat_j.items():
        td = flat_t[path]
        assert td.shape == d.shape and td.init == d.init and td.scale == d.scale, path
        assert td.dtype == DTYPES[jnp.dtype(d.dtype)], path
    assert LM(port_config(ref)).param_count() == JLM(ref, RULES).param_count()


def models(ref_cfg: JConfig):
    """(reference model, its params, port model, the same params), the VLM's
    gates set to ``VLM_GATE``.  ``convert`` gives every leaf its declared
    dtype (the SSM's fp32 leaves in a bf16 model; the VLM's 0-d gates stacked
    over its cross layers) and the reference's values exactly."""
    jm = JLM(ref_cfg, RULES)
    jp = jm.init(jax.random.PRNGKey(0))
    if ref_cfg.family == "vlm":
        gate = jp["cross_blocks"]["xattn"]["gate"]
        jp["cross_blocks"]["xattn"]["gate"] = jnp.full_like(gate, VLM_GATE)
    cfg = port_config(ref_cfg)
    tp = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                          device="cpu")
    decls, ref = leaves(LM(cfg).decls()), leaves(jp)
    for path, leaf in leaves(tp).items():
        assert leaf.dtype == decls[path].dtype and tuple(leaf.shape) == decls[path].shape, path
        np.testing.assert_array_equal(to_np(leaf), to_np(ref[path]), err_msg=path)
    return jm, jp, LM(cfg), tp


def inputs(cfg, b: int, s: int, seed: int = 0) -> dict:
    """numpy inputs: tokens, or frame embeddings (normal x 0.1) for
    ``embeddings_in``; images (normal x 0.1, tests/test_arch_smoke.py:26) for
    the VLM; labels."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, size=(b, s))}
    if cfg.embeddings_in:
        out["embeddings"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, size=(b, s))
    if cfg.family == "vlm":
        out["images"] = (rng.standard_normal((b, cfg.n_image_tokens, cfg.d_image))
                         * 0.1).astype(np.float32)
    return out


def cut(batch: dict, a: int, b: int, *, labels=False) -> tuple[dict, dict]:
    """Positions a:b of the sequence inputs (images whole), for both packages."""
    out = {}
    for k, v in batch.items():
        if k == "labels" and not labels:
            continue
        out[k] = v if k == "images" else v[:, a:b]
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.tensor(v) for k, v in out.items()})


def check_lm_fp32(ref_cfg: JConfig, b=2, s=12, steps=8) -> None:
    """Hidden states and prefill logits 1e-4, every cache leaf 1e-4 x max(1,
    max|leaf|), decode logits 1e-3 and the cache after decoding 1e-3 x
    max(1, max|leaf|) (tests/test_models.py:124-161's rules).  The cache
    leaves are held relative to their magnitude: the hybrid's second shared
    attention reads a residual that the first one's random-init softmax
    (scores in the hundreds) amplifies, so its K and V (|x| ~ 40) part by
    ~4e-4 while the same attention on the same input moves its output by
    7e-6 of its own magnitude."""
    jm, jp, tm, tp = models(ref_cfg)
    data = inputs(tm.cfg, b, s + steps)
    jb, tb = cut(data, 0, s)
    hidden, aux = jax.jit(jm.forward)(jp, jb)
    thidden, taux = tm.forward(tp, tb)
    close(thidden, hidden, 1e-4, what="hidden")
    close(taux, aux, 1e-5, what="aux")
    jlog, jcache = jax.jit(jm.prefill)(jp, jb)
    tlog, tcache = tm.prefill(tp, tb)
    close(tlog, jlog, 1e-4, what="prefill logits")
    jl, tl = leaves(jcache), leaves(tcache)
    assert set(jl) == set(tl)
    for path in jl:
        close(tl[path], jl[path], 1e-4, rel_to_max=True, what=f"prefill cache {path}")
    if "layers/ssm" in tl:
        assert tl["layers/ssm"].dtype == torch.float32
    jcache, tcache = jgrow_cache(jcache, steps), serve.grow_cache(tcache, steps)
    step = jax.jit(jm.decode_step)
    for t in range(s, s + steps):
        jd, td = cut(data, t, t + 1)
        jd.pop("images", None)
        td.pop("images", None)
        jlog, jcache = step(jp, jcache, jd, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, td, t)
        close(tlog, jlog, 1e-3, what=f"decode logits at {t}")
    jl, tl = leaves(jcache), leaves(tcache)
    for path in jl:
        close(tl[path], jl[path], 1e-3, rel_to_max=True, what=f"decoded cache {path}")


def check_lm_bf16(ref_cfg: JConfig, b=2, s=16, steps=4) -> None:
    """bf16 as tests/test_torch_lm.py holds the dense LM: hidden states,
    prefill logits and every cache leaf within 3e-2 of max(1, max|x|) of the
    reference's; decode logits no farther from the fp32 ones (the reference
    at fp32 on the same bf16-rounded weights) than the reference's own bf16
    logits, plus that."""
    jm, jp, tm, tp = models(dataclasses.replace(ref_cfg, dtype=jnp.bfloat16))
    j32 = JLM(dataclasses.replace(jm.cfg, dtype=jnp.float32), RULES)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    data = inputs(tm.cfg, b, s + steps, seed=1)
    jb, tb = cut(data, 0, s)
    hidden, _ = jax.jit(jm.forward)(jp, jb)
    close(tm.forward(tp, tb)[0], hidden, 3e-2, rel_to_max=True, what="hidden")
    jlog, jcache = jax.jit(jm.prefill)(jp, jb)
    tlog, tcache = tm.prefill(tp, tb)
    close(tlog, jlog, 3e-2, rel_to_max=True, what="prefill logits")
    jl, tl = leaves(jcache), leaves(tcache)
    for path in jl:
        close(tl[path], jl[path], 3e-2, rel_to_max=True, what=f"prefill cache {path}")
    _, j32cache = jax.jit(j32.prefill)(jp32, jb)
    jcache, tcache = jgrow_cache(jcache, steps), serve.grow_cache(tcache, steps)
    j32cache = jgrow_cache(j32cache, steps)
    step, step32 = jax.jit(jm.decode_step), jax.jit(j32.decode_step)
    for t in range(s, s + steps):
        jd, td = cut(data, t, t + 1)
        jd.pop("images", None)
        td.pop("images", None)
        jlog, jcache = step(jp, jcache, jd, jnp.int32(t))
        exact, j32cache = step32(jp32, j32cache, jd, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, td, t)
        exact = to_np(exact)
        ref_err = float(np.abs(to_np(jlog) - exact).max())
        close(tlog, exact, ref_err + 3e-2 * max(1.0, float(np.abs(exact).max())),
              what=f"decode logits at {t}")


def rel(a, b) -> float:
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def port_grads(model, params, batch, n_clients=2):
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, metrics = model.loss(live, batch, n_clients)
    paths, flat = tree_flatten_with_paths(live)
    return loss, metrics, dict(zip(paths, torch.autograd.grad(loss, flat, allow_unused=True)))


def check_loss_and_grads(ref_cfg: JConfig, b=4, s=16) -> None:
    """``LM.loss`` (total, CE, aux, MMD at two FDA clients) 1e-4 of max(1,
    |x|) and every gradient leaf against ``jax.value_and_grad`` of the
    reference's loss within 1e-4 x max(1, max|leaf|) plus four times what a
    1e-7 relative nudge of the weights moves the port's own gradient
    (tests/test_torch_train.py's rule: the random-init stack is
    ill-conditioned in fp32).  The FDA head's Omega gets no gradient."""
    jm, jp, tm, tp = models(dataclasses.replace(ref_cfg, fda_lambda=1.0))
    data = inputs(tm.cfg, b, s, seed=2)
    jb, tb = cut(data, 0, s, labels=True)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, 2), has_aux=True))(jp)
    tl, tmet, grads = port_grads(tm, tp, tb)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    for key in ("ce", "aux", "mmd"):
        assert abs(float(tmet[key].detach()) - float(jmet[key])) <= 1e-4 * max(
            1.0, abs(float(jmet[key]))), key
    assert float(tmet["mmd"].detach()) > 0
    gen = torch.Generator().manual_seed(1)
    _, _, moved = port_grads(tm, tree_map(
        lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)), tp), tb)
    ref = {p: to_np(x) for p, x in leaves(jg).items()}
    assert sorted(ref) == sorted(grads)
    for path, g in grads.items():
        if path == "fda/omega":  # frozen: no gradient reaches it (tests/test_models.py:181)
            assert g is None and float(np.abs(ref[path]).sum()) == 0.0
            continue
        nudge = rel(to_np(moved[path]), to_np(g))
        assert rel(to_np(g), ref[path]) <= 1e-4 + 4 * nudge, (path, nudge)
    if tm.cfg.family == "vlm":  # the image path reaches the loss
        assert float(grads["cross_blocks/xattn/wk"].abs().sum()) > 0


def serve_main(arch: str) -> None:
    """``serve.main`` on the CPU for the reduced arch: tokens in its vocab."""
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--gen", "4"])
    vocab = jget_config(arch).reduced().vocab_size
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < vocab)).all()


def train_main(arch: str) -> None:
    """``launch.train.main`` on the CPU for the reduced arch: finite losses."""
    from repro_torch.launch import train

    res = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--log-every", "100"])
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
