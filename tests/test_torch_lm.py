"""Port parity: the LM backbone's serve path (repro_torch.models, configs,
launch.serve) and K11's plain version vs repro on the CPU.

The same numpy inputs go through both packages.  Tolerances: K11 fp32 2e-5
and bf16 3e-2 (tests/test_kernels.py:164-187); model-layout attention 2e-5
(tests/test_models.py:42-48); the layers 1e-6 at fp32; the FDA head 1e-5;
the whole model at fp32, from the reference's ``LM.init`` tree, hidden states
and prefill logits and cache 1e-4, decode logits 1e-3
(tests/test_models.py:124-161); at bf16 3e-2 of max(1, max|x|) (the port
keeps the softmax weights fp32 in the PV product where the reference's scan
rounds them to bf16), and decode logits no farther from fp32 ones than the
reference's own bf16 logits are (test_lm_matches_reference_bf16 says why).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import grow_cache as jgrow_cache  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ShardRules  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import fda_head as jfda  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.param import is_decl  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import fda_head as tfda  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

RULES = ShardRules(model_size=1)
_DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def port_config(cfg: JConfig) -> ModelConfig:
    """The port's config with every field of the reference's."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = _DTYPES[jnp.dtype(cfg.dtype)]
    return ModelConfig(**fields)


def mk(**kw) -> JConfig:
    """tests/test_models.py:17-24's tiny dense config."""
    base = dict(
        arch_id="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=97, head_dim=16, dtype=jnp.float32, fda_n_rff=16,
        fda_m=4, remat=False,
    )
    base.update(kw)
    return JConfig(**base)


def both(x: np.ndarray, dtype=np.float32):
    """The same values as a jax array and a CPU torch tensor (bf16 rounds
    to nearest even in both)."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x, dtype), torch.tensor(np.asarray(x, dtype))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(a, b, atol, *, rel_to_max=False):
    a, b = to_np(a), to_np(b)
    tol = atol * max(1.0, float(np.abs(b).max())) if rel_to_max else atol
    err = float(np.abs(a - b).max())
    assert err <= tol, f"max abs err {err} > {tol}"
    return err


# ---------------------------------------------------------------------------
# K11's plain version against the reference kernel (Pallas, interpret mode)
# ---------------------------------------------------------------------------

SWEEP = [(1, 2, 1, 128, 32, 32), (2, 4, 2, 128, 16, 16), (1, 4, 4, 256, 32, 16),
         (2, 8, 2, 64, 64, 64),  # tests/test_kernels.py:164-166
         (1, 4, 4, 128, 192, 128), (1, 2, 1, 128, 20, 12)]  # MLA's d 192 / dv 128; a ragged row


def _qkv(b, h, kv, s, d, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, dv)).astype(np.float32))


@pytest.mark.parametrize("b,h,kv,s,d,dv", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_plain_matches_reference_kernel(b, h, kv, s, d, dv, dtype, window):
    arrays = _qkv(b, h, kv, s, d, dv, b * h * s + window)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "bf16" if dtype == "bf16" else np.float32)
                                    for a in arrays)
    exp = jops.flash_attention(jq, jk, jv, window=window, block_q=64, block_k=64)
    launches = tfa.LAUNCHES["flash_attention"]
    out = ops.flash_attention(tq, tk, tv, window=window)
    assert tfa.LAUNCHES["flash_attention"] == launches  # CPU tensors: the plain version
    assert out.dtype == tq.dtype and tuple(out.shape) == (b, h, s, dv)
    close(out, exp, 3e-2 if dtype == "bf16" else 2e-5)


def test_flash_attention_plain_non_causal_matches_reference_kernel():
    (jq, tq), (jk, tk), (jv, tv) = (both(a) for a in _qkv(1, 2, 2, 64, 16, 16, 0))
    exp = jops.flash_attention(jq, jk, jv, causal=False, block_q=32, block_k=32)
    close(ops.flash_attention(tq, tk, tv, causal=False), exp, 2e-5)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros((1, 3, 8, 4))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 2, 8, 4)), torch.zeros((1, 2, 8, 4)))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 1, 7, 4)), torch.zeros((1, 1, 7, 4)))


@pytest.mark.parametrize("window", [0, 24])
def test_model_flash_attention_matches_reference(window):
    rng = np.random.default_rng(window)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16))]
    (jq, tq), (jk, tk), (jv, tv) = (both(a) for a in arrays)
    exp = jattn.flash_attention(jq, jk, jv, causal=True, window=window)
    close(tattn.flash_attention(tq, tk, tv, causal=True, window=window), exp, 2e-5)


# ---------------------------------------------------------------------------
# layers and the FDA head
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    (jx, tx), (js, ts) = both(x), both(scale)
    close(tlayers.rmsnorm({"scale": ts}, tx, 1e-5), jlayers.rmsnorm({"scale": js}, jx, 1e-5),
          1e-6)

    heads = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    (jh, th) = both(heads)
    pos = np.arange(16)
    close(tlayers.apply_rope(th, torch.tensor(pos), 10_000.0),
          jlayers.apply_rope(jh, jnp.asarray(pos), 10_000.0), 1e-6)
    close(tlayers.rope_frequencies(16, 10_000.0), jlayers.rope_frequencies(16, 10_000.0), 0.0)

    w = {k: (rng.standard_normal(shape) / 8).astype(np.float32)
         for k, shape in (("gate", (64, 96)), ("up", (64, 96)), ("down", (96, 64)))}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.tensor(v) for k, v in w.items()}
    close(tlayers.mlp(tw, tx), jlayers.mlp(jw, jx), 1e-6)

    table = {"embed": rng.standard_normal((128, 64)).astype(np.float32),
             "unembed": (rng.standard_normal((64, 128)) / 8).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in table.items()}
    tt = {k: torch.tensor(v) for k, v in table.items()}
    toks = rng.integers(0, 128, size=(2, 16))
    close(tlayers.embed(tt, torch.tensor(toks)), jlayers.embed(jt, jnp.asarray(toks)), 0.0)
    close(tlayers.unembed(tt, tx), jlayers.unembed(jt, jx), 1e-6)


def test_fda_head_matches_reference():
    rng = np.random.default_rng(4)
    params = {"omega": (2.0 * rng.standard_normal((16, 64))).astype(np.float32),
              "w_rf": (rng.standard_normal((32, 4)) / np.sqrt(32)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    (jh, th) = both(rng.standard_normal((8, 12, 64)).astype(np.float32))
    close(tfda.fda_messages(tp, th, 4), jfda.fda_messages(jp, jh, 4), 1e-5)
    close(tfda.fda_loss(tp, th, 4), jfda.fda_loss(jp, jh, 4), 1e-5)


# ---------------------------------------------------------------------------
# configs and parameter declarations
# ---------------------------------------------------------------------------

def test_configs_copy_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        ref = jget_config(arch)
        assert get_config(arch) == port_config(ref), arch
        assert get_config(arch).reduced() == port_config(ref.reduced()), arch
        assert get_config(arch).vocab_padded == ref.vocab_padded and get_config(arch).hd == ref.hd


@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-360m", "internlm2-1.8b",
                                  "command-r-plus-104b"])
def test_dense_decls_match_reference(arch):
    ref = jget_config(arch)
    jdecls = JLM(ref, RULES).decls()
    tdecls = LM(port_config(ref)).decls()
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jdecls, is_leaf=is_decl)[0])
    flat_t = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                flat_t[(*path, k)] = v

    walk(tdecls, ())
    assert {tuple(p.key for p in kp) for kp in flat_j} == set(flat_t)
    for kp, d in flat_j.items():
        td = flat_t[tuple(p.key for p in kp)]
        assert td.shape == d.shape and td.init == d.init and td.scale == d.scale
        assert td.dtype == _DTYPES[jnp.dtype(d.dtype)]
    assert LM(port_config(ref)).param_count() == JLM(ref, RULES).param_count()


def test_port_init_is_seeded_and_device_independent():
    cfg = port_config(mk())
    a, b = LM(cfg).init(0, device="cpu"), LM(cfg).init(0, device="cpu")
    c = LM(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    wq = a["blocks"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"]["attn"]["wq"])
    assert not torch.equal(wq[0], wq[1])  # the layers are drawn apart
    # std of a "normal" leaf: scale / sqrt(fan_in), fan_in = shape[-2]
    emb = a["embedding"]["embed"]
    assert abs(float(emb.std()) - 1 / np.sqrt(emb.shape[-2])) < 0.05 / np.sqrt(emb.shape[-2])
    assert torch.equal(a["blocks"]["ln_attn"]["scale"], torch.ones((2, 64)))
    assert a["fda"]["omega"].dtype == torch.float32
    # an SSM and a VLM in bf16: the "ssm_a", "ssm_dt" and "zeros" inits, the
    # SSM's fp32 leaves, the VLM's 0-d gate stacked over its cross layers
    ssm_kw = dict(family="ssm", ssm_state=16, ssm_head_dim=16, ssm_chunk=8, d_ff=0)
    vlm_kw = dict(family="vlm", cross_attn_every=1, n_layers=3, n_image_tokens=8, d_image=32)
    for kw in (ssm_kw, vlm_kw):
        fcfg = port_config(mk(**kw, dtype=jnp.bfloat16))
        p1, p2 = LM(fcfg).init(0, device="cpu"), LM(fcfg).init(0, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(p1), tree_leaves(p2)))
    ssm = LM(port_config(mk(**ssm_kw, dtype=jnp.bfloat16))).init(0, device="cpu")["blocks"]["ssm"]
    for key in ("a_log", "dt_bias", "d_skip"):
        assert ssm[key].dtype == torch.float32 and ssm[key].shape == (2, 8)
    a_init = torch.exp(ssm["a_log"])  # U[1, 16]
    dt_init = torch.nn.functional.softplus(ssm["dt_bias"])  # U[1e-3, 1e-1]
    assert float(a_init.min()) >= 1.0 and float(a_init.max()) <= 16.0
    assert float(dt_init.min()) >= 1e-3 * (1 - 1e-5) and float(dt_init.max()) <= 1e-1 * (1 + 1e-5)
    assert not torch.equal(ssm["a_log"][0], ssm["a_log"][1])
    assert torch.equal(ssm["d_skip"], torch.ones((2, 8)))
    assert ssm["w_z"].dtype == torch.bfloat16
    gate = LM(port_config(mk(**vlm_kw, dtype=jnp.bfloat16))).init(0, device="cpu")[
        "cross_blocks"]["xattn"]["gate"]
    assert gate.dtype == torch.bfloat16 and torch.equal(gate, torch.zeros((1,),
                                                                          dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the whole slice: the reference's weights through both packages
# ---------------------------------------------------------------------------

CONFIGS = {
    "tiny": mk,
    "smollm-135m-reduced": lambda **kw: dataclasses.replace(
        jget_config("smollm-135m").reduced(), **kw),
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
    vocab = tm.cfg.vocab_size
    b, s, steps = 2, 12, 16
    toks = _tokens(b, s + steps, vocab)
    jt, tt = jnp.asarray(toks), torch.tensor(toks)
    hidden, _ = jm.forward(jp, {"tokens": jt[:, :s]})
    close(tm.forward(tp, {"tokens": tt[:, :s]})[0], hidden, 1e-4)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jt[:, :s]})
    tlog, tcache = tm.prefill(tp, {"tokens": tt[:, :s]})
    close(tlog, jlog, 1e-4)
    for key in ("k", "v"):
        assert tuple(tcache["layers"][key].shape) == jcache["layers"][key].shape
        close(tcache["layers"][key], jcache["layers"][key], 1e-4)
    jcache, tcache = jgrow_cache(jcache, steps), serve.grow_cache(tcache, steps)
    step = jax.jit(jm.decode_step)
    for t in range(s, s + steps):
        jlog, jcache = step(jp, jcache, {"tokens": jt[:, t:t + 1]}, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, {"tokens": tt[:, t:t + 1]}, t)
        close(tlog, jlog, 1e-3)


def test_lm_matches_reference_bf16():
    """bf16: hidden states, prefill logits and cache within 3e-2 of max(1,
    max|x|) of the reference's.  Decode logits: no farther from the fp32
    logits (the reference at fp32 on the same bf16-rounded weights) than the
    reference's own bf16 logits, within that tolerance.  Per op the two
    packages agree within a bf16 ULP, but a random-init residual stream of
    magnitude ~100 ahead of the final norm turns single-ULP flips into
    logit differences of ~0.25 at some steps, where the reference's own bf16
    logits are ~0.5 off its fp32 ones."""
    jm, jp, tm, tp = _models("smollm-135m-reduced", dtype=jnp.bfloat16)
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(tp["blocks"]["attn"]["wq"].float(),
                       torch.tensor(np.asarray(jp["blocks"]["attn"]["wq"], np.float32)))
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
    for key in ("k", "v"):
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


def test_sliding_window_ring_buffer_matches_reference():
    """tests/test_models.py:164-180 through both packages: a ring cache of
    size window = 8 over 24 tokens, and the port's ring decode against its
    own windowed forward."""
    jm, jp, tm, tp = _models("tiny", attn_window=8)
    b, s = 1, 24
    toks = _tokens(b, s, 97, seed=2)
    jt, tt = jnp.asarray(toks), torch.tensor(toks)
    full = tm.logits(tp, tm.forward(tp, {"tokens": tt})[0])
    jcache, tcache = jm.init_cache(b, 8), tm.init_cache(b, 8, device="cpu")
    assert tuple(tcache["layers"]["k"].shape) == jcache["layers"]["k"].shape == (2, 1, 8, 2, 16)
    step = jax.jit(jm.decode_step)
    for t in range(s):
        jlog, jcache = step(jp, jcache, {"tokens": jt[:, t:t + 1]}, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, tcache, {"tokens": tt[:, t:t + 1]}, t)
        close(tlog, jlog, 1e-3)
        close(tlog, full[:, t], 1e-3)
    close(tcache["layers"]["k"], jcache["layers"]["k"], 1e-4)


def test_generate_matches_reference_serve_loop():
    """Greedy tokens of ``serve.generate`` equal the reference serve loop's
    (``repro.launch.serve.main``'s prefill, ``grow_cache``, argmax decode) on
    the same weights and prompts at fp32."""
    jm, jp, tm, tp = _models("smollm-135m-reduced")
    b, s, gen = 3, 10, 8
    prompts = _tokens(b, s, tm.cfg.vocab_size, seed=3)
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompts)})
    cache = jgrow_cache(cache, gen)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, :tm.cfg.vocab_size], axis=-1)[:, None]
    ref = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(jp, cache, {"tokens": tok}, jnp.int32(s + i))
        tok = jnp.argmax(logits[:, :tm.cfg.vocab_size], axis=-1)[:, None]
        ref.append(np.asarray(tok))
    res = serve.generate(tm, tp, torch.tensor(prompts), gen)
    assert res["tokens"].shape == (b, gen) and len(res["logits"]) == gen
    assert len(res["step_ms"]) == gen - 1 and res["prefill_s"] > 0
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(ref, axis=1))


# ---------------------------------------------------------------------------
# the port's own invariants (tests/test_models.py:124-161, dense)
# ---------------------------------------------------------------------------

def test_port_decode_matches_forward():
    cfg = port_config(mk())
    model = LM(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 16
    toks = torch.tensor(_tokens(b, s, 97, seed=4))
    full = model.logits(params, model.forward(params, {"tokens": toks})[0])
    cache = model.init_cache(b, s, device="cpu")
    errs = []
    for t in range(s):
        logits, cache = model.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 1e-3, max(errs)


def test_port_prefill_handoff():
    cfg = port_config(mk())
    model = LM(cfg)
    params = model.init(1, device="cpu")
    b, s, extra = 2, 16, 4
    toks = torch.tensor(_tokens(b, s + extra, 97, seed=5))
    full = model.logits(params, model.forward(params, {"tokens": toks})[0])
    logits_p, cache = model.prefill(params, {"tokens": toks[:, :s]})
    assert float((logits_p - full[:, s - 1]).abs().max()) < 1e-4
    cache = serve.grow_cache(cache, extra)
    assert tuple(cache["layers"]["k"].shape) == (2, b, s + extra, 2, 16)
    for t in range(s, s + extra):
        logits, cache = model.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t)
        assert float((logits - full[:, t]).abs().max()) < 1e-3


def test_serve_main_on_cpu():
    out = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                      "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
