"""Port parity: the MoE family with GQA and MLA attention (repro_torch.models.moe,
attention.mla_*, blocks, model, launch.serve) against repro on the CPU, and
``param.materialize``'s chunked draws.

The same numpy inputs go through both packages.  Tolerances: ``moe_forward``
2e-5 at fp32 (y and aux) and, at bf16, 3e-2 of max(1, max|y|) (the rule of
test_torch_lm.py::test_lm_matches_reference_bf16), with the routing (the top
k experts in order, and which pairs the capacity keeps) equal; ``capacity``
equal; MLA's prefill and absorbed decode 2e-5; the moe and mla LMs of
tests/test_models.py:113-121 and both architectures' ``reduced()`` configs,
from the reference's ``LM.init`` tree through ``convert``: hidden states,
prefill logits and caches 1e-4, decode logits 1e-3 at fp32, as the dense
LM's (test_torch_lm.py); at bf16 as there; greedy tokens equal to the
reference's serve loop; ``LM.loss`` and its CE, aux and MMD 1e-4.
``materialize`` in chunks equals the whole draw bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.launch.serve import grow_cache as jgrow_cache  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ShardRules  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.param import is_decl  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402

RULES = ShardRules(model_size=1)
_DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")


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


def port_config(cfg: JConfig) -> ModelConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = _DTYPES[jnp.dtype(cfg.dtype)]
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


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(a, b, atol, *, rel_to_max=False):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = atol * max(1.0, float(np.abs(b).max())) if rel_to_max else atol
    err = float(np.abs(a - b).max())
    assert err <= tol, f"max abs err {err} > {tol}"
    return err


def both(x: np.ndarray, dtype):
    """The same values as a jax array and a CPU torch tensor (bf16 rounds to
    nearest even in both)."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x, jnp.float32), torch.tensor(np.asarray(x, np.float32))


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, (*path, k))
        else:
            yield (*path, k), v


# ---------------------------------------------------------------------------
# declarations and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decls_match_reference(arch):
    ref = jget_config(arch)
    flat_j = {tuple(p.key for p in kp): d for kp, d in jax.tree_util.tree_flatten_with_path(
        JLM(ref, RULES).decls(), is_leaf=is_decl)[0]}
    flat_t = dict(_walk(LM(port_config(ref)).decls()))
    assert set(flat_j) == set(flat_t)
    for kp, d in flat_j.items():
        td = flat_t[kp]
        assert td.shape == d.shape and td.init == d.init and td.scale == d.scale, kp
        assert td.dtype == _DTYPES[jnp.dtype(d.dtype)], kp
    assert LM(port_config(ref)).param_count() == JLM(ref, RULES).param_count()


def test_capacity_matches_reference():
    for arch in ARCHS:
        ref = jget_config(arch)
        for kw in ({}, {"capacity_factor": 1.0}, {"capacity_factor": 8.0}):
            rc = dataclasses.replace(ref, **kw)
            for t in (1, 4, 8, 64, 256, 8192, 8193):
                assert tmoe.capacity(port_config(rc), t) == jmoe.capacity(rc, t), (arch, kw, t)


# ---------------------------------------------------------------------------
# moe_forward on the same numpy weights
# ---------------------------------------------------------------------------

def _moe_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
         "gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "down": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        w["shared"] = {"gate": (rng.standard_normal((d, fs)) / np.sqrt(d)).astype(np.float32),
                       "up": (rng.standard_normal((d, fs)) / np.sqrt(d)).astype(np.float32),
                       "down": (rng.standard_normal((fs, d)) / np.sqrt(fs)).astype(np.float32)}
    return w


def _both_trees(w, dtype):
    """The weights in both packages; the router stays fp32 as declared."""
    jt, tt = {}, {}
    for k, v in w.items():
        if isinstance(v, dict):
            jt[k], tt[k] = _both_trees(v, dtype)
        else:
            jt[k], tt[k] = both(v, np.float32 if k == "router" else dtype)
    return jt, tt


def _reference_routing(jw, jx, cfg):
    """The reference's own routing steps (src/repro/models/moe.py:49-70)."""
    t = jx.shape[0] * jx.shape[1]
    xt = jx.reshape(t, -1)
    probs = jax.nn.softmax((xt.astype(jnp.float32) @ jw["router"]).astype(jnp.float32), -1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    flat_e = top_e.reshape(-1)
    one_hot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(one_hot, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(top_e), np.asarray(pos < jmoe.capacity(cfg, t))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_matches_reference(dtype, capacity_factor, shared):
    rc = mk(family="moe", n_experts=8, top_k=2, n_shared_experts=shared, d_ff=32,
            capacity_factor=capacity_factor,
            dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    cfg = port_config(rc)
    jw, tw = _both_trees(_moe_weights(cfg, 7 + shared), dtype)
    x = np.random.default_rng(11).standard_normal((4, 32, 64)).astype(np.float32)
    jx, tx = both(x, dtype)
    y, aux = jmoe.moe_forward(jw, jx, rc)
    ty, taux = tmoe.moe_forward(tw, tx, cfg)
    assert ty.dtype == cfg.dtype and tuple(ty.shape) == x.shape
    top_e, keep = _reference_routing(jw, jx, rc)
    probs, _, t_top = tmoe.route(tw, tx.reshape(-1, 64), cfg)
    _, t_keep = tmoe.dispatch(t_top, cfg.n_experts, tmoe.capacity(cfg, 128))
    np.testing.assert_array_equal(t_top.numpy(), top_e)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if capacity_factor == 1.0:
        assert not keep.all()  # pairs past the capacity are dropped
    if dtype == "f32":
        close(ty, y, 2e-5)
    else:
        close(ty, y, 3e-2, rel_to_max=True)
    close(taux, aux, 2e-5)


@pytest.mark.parametrize("top_k", [4, 2])
def test_zero_router_ties_route_like_reference(top_k):
    """tests/test_models.py:98-109: a zero router makes every probability a
    tie; the reference's top_k takes the lower experts first, and so does the
    port.  With top_k = E the aux loss is 1."""
    rc = mk(family="moe", n_experts=4, top_k=top_k, d_ff=32, capacity_factor=4.0)
    cfg = port_config(rc)
    w = _moe_weights(cfg, 3)
    w["router"] = np.zeros_like(w["router"])
    jw, tw = _both_trees(w, "f32")
    jx, tx = both(np.random.default_rng(5).standard_normal((2, 32, 64)), "f32")
    top_e, keep = _reference_routing(jw, jx, rc)
    _, _, t_top = tmoe.route(tw, tx.reshape(-1, 64), cfg)
    np.testing.assert_array_equal(t_top.numpy(), top_e)
    assert (top_e == np.arange(top_k)).all()
    y, aux = jmoe.moe_forward(jw, jx, rc)
    ty, taux = tmoe.moe_forward(tw, tx, cfg)
    close(ty, y, 2e-5)
    close(taux, aux, 1e-6)
    if top_k == 4:
        assert abs(float(taux) - 1.0) < 1e-2


# ---------------------------------------------------------------------------
# MLA: prefill through K11's plain version, absorbed decode
# ---------------------------------------------------------------------------

def _mla_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, hd, r, rd = cfg.d_model, cfg.n_heads, cfg.hd, cfg.kv_lora_rank, cfg.rope_head_dim
    shapes = {"wq_nope": (d, h, hd), "wq_rope": (d, h, rd), "w_dkv": (d, r),
              "w_krope": (d, rd), "w_uk": (r, h, hd), "w_uv": (r, h, hd), "wo": (h, hd, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0] if k != "wo" else s[0] * s[1]))
            .astype(np.float32) for k, s in shapes.items()}


def test_mla_forward_and_decode_match_reference():
    rc = mk(family="moe", n_experts=4, top_k=2, kv_lora_rank=32, rope_head_dim=16, d_ff=64)
    cfg = port_config(rc)
    jw, tw = _both_trees(_mla_weights(cfg, 2), "f32")
    b, s, extra = 2, 24, 4
    jx, tx = both(np.random.default_rng(9).standard_normal((b, s + extra, 64)), "f32")
    pos = np.arange(s)
    out, (c, kr) = jattn.mla_forward(jw, jx[:, :s], jnp.asarray(pos), rc, return_cache=True)
    tout, (tc, tkr) = tattn.mla_forward(tw, tx[:, :s], torch.tensor(pos), cfg, return_cache=True)
    close(tout, out, 2e-5)
    close(tc, c, 2e-5)
    close(tkr, kr, 2e-5)
    jc = jnp.pad(c, ((0, 0), (0, extra), (0, 0)))
    jkr = jnp.pad(kr, ((0, 0), (0, extra), (0, 0)))
    tc = torch.nn.functional.pad(tc, (0, 0, 0, extra))
    tkr = torch.nn.functional.pad(tkr, (0, 0, 0, extra))
    for t in range(s, s + extra):
        o, jc, jkr = jattn.mla_decode(jw, jx[:, t:t + 1], jc, jkr, jnp.int32(t), rc)
        to, tc2, tkr2 = tattn.mla_decode(tw, tx[:, t:t + 1], tc, tkr, t, cfg)
        assert tc2 is tc and tkr2 is tkr  # the new columns are written in place
        close(to, o, 2e-5)
        close(tc, jc, 2e-5)
        close(tkr, jkr, 2e-5)


# ---------------------------------------------------------------------------
# the whole slice: the reference's weights through both packages
# ---------------------------------------------------------------------------

CONFIGS = {
    # tests/test_models.py:113-121
    "moe": lambda **kw: mk(**{**dict(family="moe", n_experts=4, top_k=2, n_shared_experts=1,
                                     d_ff=64, capacity_factor=8.0), **kw}),
    "mla": lambda **kw: mk(**{**dict(family="moe", n_experts=4, top_k=2, kv_lora_rank=32,
                                     rope_head_dim=16, d_ff=64, capacity_factor=8.0), **kw}),
    # both architectures at their reduced() widths (the default capacity factor)
    **{f"{arch}-reduced": (lambda arch: lambda **kw: dataclasses.replace(
        jget_config(arch).reduced(), **kw))(arch) for arch in ARCHS},
}


def _models(name, **kw):
    ref_cfg = CONFIGS[name](**kw)
    jmodel = JLM(ref_cfg, RULES)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_config(ref_cfg)
    tparams = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                               device="cpu")
    return jmodel, jparams, LM(cfg), tparams


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_matches_reference_fp32(name):
    jm, jp, tm, tp = _models(name)
    b, s, steps = 2, 12, 8
    toks = _tokens(b, s + steps, tm.cfg.vocab_size)
    jt, tt = jnp.asarray(toks), torch.tensor(toks)
    hidden, aux = jm.forward(jp, {"tokens": jt[:, :s]})
    thidden, taux = tm.forward(tp, {"tokens": tt[:, :s]})
    close(thidden, hidden, 1e-4)
    close(taux, aux, 1e-5)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jt[:, :s]})
    tlog, tcache = tm.prefill(tp, {"tokens": tt[:, :s]})
    close(tlog, jlog, 1e-4)
    assert set(tcache["layers"]) == set(jcache["layers"])
    for key in jcache["layers"]:
        close(tcache["layers"][key], jcache["layers"][key], 1e-4)
    jcache, tcache = jgrow_cache(jcache, steps), serve.grow_cache(tcache, steps)
    step = jax.jit(jm.decode_step)
    for t in range(s, s + steps):
        jlog, jcache = step(jp, jcache, {"tokens": jt[:, t:t + 1]}, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, {"tokens": tt[:, t:t + 1]}, t)
        close(tlog, jlog, 1e-3)


@pytest.mark.parametrize("name", ["moe", "mla"])
def test_lm_matches_reference_bf16(name):
    """bf16 as test_torch_lm.py holds the dense LM: hidden states, prefill
    logits and caches within 3e-2 of max(1, max|x|) of the reference's; decode
    logits no farther from the fp32 ones (the reference at fp32 on the same
    bf16-rounded weights) than the reference's own bf16 logits, plus that."""
    jm, jp, tm, tp = _models(name, dtype=jnp.bfloat16)
    assert tp["blocks"]["moe"]["gate"].dtype == torch.bfloat16
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    j32 = JLM(dataclasses.replace(jm.cfg, dtype=jnp.float32), RULES)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    b, s, steps = 2, 16, 4
    toks = _tokens(b, s + steps, tm.cfg.vocab_size, seed=1)
    jt, tt = jnp.asarray(toks), torch.tensor(toks)
    hidden, _ = jm.forward(jp, {"tokens": jt[:, :s]})
    close(tm.forward(tp, {"tokens": tt[:, :s]})[0], hidden, 3e-2, rel_to_max=True)
    jlog, jcache = jm.prefill(jp, {"tokens": jt[:, :s]})
    tlog, tcache = tm.prefill(tp, {"tokens": tt[:, :s]})
    close(tlog, jlog, 3e-2, rel_to_max=True)
    for key in jcache["layers"]:
        close(tcache["layers"][key], jcache["layers"][key], 3e-2, rel_to_max=True)
    _, j32cache = j32.prefill(jp32, {"tokens": jt[:, :s]})
    jcache, tcache = jgrow_cache(jcache, steps), serve.grow_cache(tcache, steps)
    j32cache = jgrow_cache(j32cache, steps)
    step, step32 = jax.jit(jm.decode_step), jax.jit(j32.decode_step)
    for t in range(s, s + steps):
        tok = {"tokens": jt[:, t:t + 1]}
        jlog, jcache = step(jp, jcache, tok, jnp.int32(t))
        exact, j32cache = step32(jp32, j32cache, tok, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, {"tokens": tt[:, t:t + 1]}, t)
        exact = to_np(exact)
        ref_err = float(np.abs(to_np(jlog) - exact).max())
        close(tlog, exact, ref_err + 3e-2 * max(1.0, float(np.abs(exact).max())))


@pytest.mark.parametrize("name", ["moe", "mla"])
def test_generate_matches_reference_serve_loop(name):
    """Greedy tokens of ``serve.generate`` equal the reference serve loop's
    (prefill, ``grow_cache``, argmax decode) on the same weights at fp32."""
    jm, jp, tm, tp = _models(name)
    b, s, gen = 3, 10, 8
    vocab = tm.cfg.vocab_size
    prompts = _tokens(b, s, vocab, seed=3)
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompts)})
    cache = jgrow_cache(cache, gen)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, :vocab], axis=-1)[:, None]
    ref = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(jp, cache, {"tokens": tok}, jnp.int32(s + i))
        tok = jnp.argmax(logits[:, :vocab], axis=-1)[:, None]
        ref.append(np.asarray(tok))
    res = serve.generate(tm, tp, torch.tensor(prompts), gen)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(ref, axis=1))


@pytest.mark.parametrize("name", ["moe", "mla"])
def test_lm_loss_matches_reference(name):
    """``LM.loss`` with two FDA clients: total, CE, the MoE aux and the MMD."""
    jm, jp, tm, tp = _models(name, fda_lambda=1.0)
    toks = _tokens(4, 16, tm.cfg.vocab_size, seed=6)
    labels = _tokens(4, 16, tm.cfg.vocab_size, seed=7)
    jtotal, jparts = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, 2)
    ttotal, tparts = tm.loss(tp, {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)},
                             2)
    close(ttotal, jtotal, 1e-4)
    for key in ("ce", "aux", "mmd"):
        close(tparts[key], jparts[key], 1e-4)
    assert float(tparts["aux"]) > 0 and float(tparts["mmd"]) > 0


@pytest.mark.parametrize("name", ["moe", "mla"])
def test_port_decode_matches_forward(name):
    """tests/test_models.py:124-138 on the port's own weights."""
    cfg = port_config(CONFIGS[name]())
    model = LM(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 16
    toks = torch.tensor(_tokens(b, s, cfg.vocab_size, seed=4))
    full = model.logits(params, model.forward(params, {"tokens": toks})[0])
    cache = model.init_cache(b, s, device="cpu")
    keys = {"moe": {"k", "v"}, "mla": {"c", "kr"}}[name]
    assert set(cache["layers"]) == keys
    for t in range(s):
        logits, cache = model.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t)
        assert float((logits - full[:, t]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < get_config(arch).reduced().vocab_size)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build(arch):
    """Both architectures build at full width and depth (no weights drawn),
    with the reference's parameter count."""
    model = LM(get_config(arch))
    assert model.param_count() == JLM(jget_config(arch), RULES).param_count()
    shapes = model.cache_shapes(4, 2064)["layers"]
    if get_config(arch).kv_lora_rank:
        assert shapes == {"c": (27, 4, 2064, 512), "kr": (27, 4, 2064, 64)}
    else:
        assert shapes == {"k": (94, 4, 2064, 4, 128), "v": (94, 4, 2064, 4, 128)}


# ---------------------------------------------------------------------------
# materialize: chunked draws equal the whole draw
# ---------------------------------------------------------------------------

def _whole(decls, seed):
    """Each leaf as one ``torch.randn`` of its shape from its own generator,
    scaled and cast: the draw before chunking."""
    out = {}
    for path, d in _walk(decls):
        keypath = "".join(f"[{k!r}]" for k in path)
        gen = torch.Generator().manual_seed(tparam._leaf_seed(seed, keypath))
        if d.init == "ones":
            leaf = torch.ones(d.shape)
        else:
            leaf = torch.randn(d.shape, generator=gen) * tparam._std(d)
        out[path] = leaf.to(d.dtype)
    return out


@pytest.mark.parametrize("chunk", [16, 48, tparam.CHUNK])
@pytest.mark.parametrize("threads", [1, 3])
def test_materialize_in_chunks_equals_the_whole_draw(monkeypatch, chunk, threads):
    """Chunks of a multiple of 16 elements (the last one at least 16) give
    the whole draw bit for bit, whether or not 16 divides a leaf or a layer
    slice: (4, 16, 64, 48) and (3, 8, 33, 16) slices are multiples, (2, 5, 7,
    9) and (3, 7) are not; a leaf under 16 elements is drawn whole.  The
    host threads change no value."""
    monkeypatch.setattr(tparam, "CHUNK", chunk)
    monkeypatch.setattr(tparam, "THREADS", threads)
    P = tparam.ParamDecl
    decls = {"a": P((4, 16, 64, 48)), "b": {"c": P((3, 8, 33, 16), "std", torch.bfloat16, 0.5),
                                            "d": P((2, 5, 7, 9))},
             "e": P((3, 7)), "f": P((5,)), "g": P((4,), "ones", torch.bfloat16)}
    got = tparam.materialize(decls, 3, device="cpu")
    exp = _whole(decls, 3)
    for path, leaf in _walk(got):
        assert leaf.dtype == exp[path].dtype and torch.equal(leaf, exp[path]), path
