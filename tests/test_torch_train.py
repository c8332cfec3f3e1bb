"""Port parity: LM training (repro_torch.data.lm, optim's AdamW, clipping and
schedules, models.layers.cross_entropy, LM.loss, launch.train) and K11's
backward (K11b's plain version and the FlashAttention autograd Function)
against repro on the CPU.

The same numpy inputs go through both packages.  Tolerances: TokenStream
arrays equal; the optimizers, clipping and schedules 1e-6; cross_entropy
1e-6; the plain attention backward 1e-5 of autograd through the plain
forward and of ``jax.vjp`` of the reference's jnp scan (fp32); the
Function's CPU path equal to plain autograd; ``LM.loss`` 1e-4 and every
gradient leaf of a reduced smollm 1e-4 x max(1, max|leaf|) at one layer.  At
two layers (``cfg.reduced()``) the random-init stack is ill-conditioned in
fp32: the embeddings' RMSNorm divides by their rms (~0.044), and a 1e-7
relative nudge of the weights moves the port's own gradients by up to
~6e-4 x max(1, max|leaf|), as far as the two packages part (~1e-3); there
each leaf is held to 1e-4 x max(1, max|leaf|) plus four times what that
nudge moves it.  Three train steps: each parameter 1e-4 x max(1,
max|leaf|) plus 2 sum(lr_t) (the most AdamW moves an element whose near-zero
gradient the two packages round to opposite signs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.lm import TokenStream as JTokenStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ShardRules  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map  # noqa: E402

RULES = ShardRules(model_size=1)


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


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _leaves(tree) -> dict:
    """path -> numpy leaf, for the reference's trees and the port's alike."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k in sorted(tree)
                for p, v in _leaves(tree[k]).items()}
    return {"": _np(tree)}


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


# ---------------------------------------------------------------------------
# data, optimizers, cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_token_stream_matches_reference(shard):
    a = TokenStream(97, 3, 17, seed=4, shard=shard)
    b = JTokenStream(97, 3, 17, seed=4, shard=shard)
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y) == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def _opt_trees(seed):
    """A parameter tree and four gradient trees of its structure (numpy)."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return {"a": (scale * rng.normal(size=(5, 3))).astype(np.float32),
                "b": {"c": (scale * rng.normal(size=(7,))).astype(np.float32),
                      "d": (scale * rng.normal(size=(2, 4))).astype(np.float32)}}

    return draw(1.0), [draw(3.0) for _ in range(4)]


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_and_clipping_match_reference(bf16):
    params, grads = _opt_trees(0)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
    tp = tree_map(lambda x: torch.tensor(x).to(tdt), params)
    jopt = joptim.adamw(joptim.cosine_schedule(1e-2, warmup=2, total=6), weight_decay=0.05)
    topt = optim.adamw(optim.cosine_schedule(1e-2, warmup=2, total=6), weight_decay=0.05)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg, jn = joptim.clip_by_global_norm(
            jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), g), 1.0)
        tg, tn = optim.clip_by_global_norm(tree_map(lambda x: torch.tensor(x).to(tdt), g), 1.0)
        assert abs(float(jn) - float(tn)) <= 1e-6 * max(1.0, float(jn))
        for path, leaf in _leaves(tg).items():
            assert leaf.dtype == _leaves(jg)[path].dtype
            np.testing.assert_allclose(leaf, _leaves(jg)[path], atol=1e-6, err_msg=path)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for path, leaf in _leaves(tp).items():
            # bf16 parameters: one bf16 rounding of p + u apart at most
            tol = 1e-2 * max(1.0, float(np.abs(leaf).max())) if bf16 else 1e-6
            np.testing.assert_allclose(leaf, _leaves(jp)[path], atol=tol, err_msg=path)
        for path, leaf in _leaves(ts.mu).items():
            assert leaf.dtype == np.float32
            np.testing.assert_allclose(leaf, _leaves(js.mu)[path], atol=1e-6, err_msg=path)
    assert int(ts.step) == int(js.step) == len(grads)


def test_schedules_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    for jf, tf in [
        (joptim.cosine_schedule(3e-4, warmup=10, total=30),
         optim.cosine_schedule(3e-4, warmup=10, total=30)),
        (joptim.cosine_schedule(1.0, warmup=0, total=7, min_frac=0.3),
         optim.cosine_schedule(1.0, warmup=0, total=7, min_frac=0.3)),
        (joptim.linear_schedule(2e-3, total=25), optim.linear_schedule(2e-3, total=25)),
        (joptim.linear_schedule(1.0, total=9, end_frac=0.2),
         optim.linear_schedule(1.0, total=9, end_frac=0.2)),
    ]:
        a = np.asarray(jf(jnp.asarray(steps)))
        b = tf(torch.tensor(steps)).numpy()
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_entropy_matches_reference(sharded, dtype):
    rng = np.random.default_rng(3)
    logits = (4 * rng.normal(size=(3, 11, 128))).astype(np.float32)
    labels = rng.integers(0, 97, size=(3, 11)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jl = jnp.asarray(logits, jdt)
    tl = torch.tensor(logits).to(tdt).requires_grad_()
    a, ga = jax.value_and_grad(lambda x: jlayers.cross_entropy(
        x, jnp.asarray(labels), 97, sharded=sharded))(jl)
    b = tlayers.cross_entropy(tl, torch.tensor(labels), 97, sharded=sharded)
    assert abs(float(a) - float(b.detach())) <= 1e-6 * max(1.0, abs(float(a)))
    (gb,) = torch.autograd.grad(b, tl)
    assert gb.dtype == tdt
    np.testing.assert_allclose(_np(gb), _np(ga), atol=1e-6)
    assert np.all(_np(gb)[..., 97:] == 0)  # padded vocab entries take no gradient


# ---------------------------------------------------------------------------
# K11b: the plain backward and the autograd Function
# ---------------------------------------------------------------------------

BWD_SHAPES = [  # (b, h, kv, s, d, dv, causal, window): GQA, MQA, window, ragged s
    (2, 4, 2, 40, 16, 16, True, 0),
    (1, 6, 2, 24, 8, 12, True, 7),
    (1, 4, 1, 40, 16, 8, False, 0),
    (1, 3, 3, 24, 8, 8, False, 5),
]


def _qkv(b, h, kv, s, d, dv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv), (b, h, s, dv)))


@pytest.mark.parametrize("b,h,kv,s,d,dv,causal,window", BWD_SHAPES)
def test_flash_backward_plain_matches_autograd_and_reference(b, h, kv, s, d, dv, causal, window):
    q, k, v, do = (torch.tensor(x) for x in _qkv(b, h, kv, s, d, dv, b * h + s + window))
    out, lse, o_acc = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                               return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    mine = fa.flash_attention_backward_plain(q, k, v, o_acc, lse, do, causal=causal,
                                             window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_plain(*leaves, causal=causal, window=window),
                              leaves, do)
    for a, r in zip(mine, ref):
        np.testing.assert_allclose(_np(a), _np(r), atol=1e-5)
    # the reference's jnp scan (models/attention.py:81), (b, s, h, d) layout
    jq, jk, jv, jdo = (jnp.asarray(_np(t).transpose(0, 2, 1, 3)) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(a, b_, c, causal=causal,
                                                            window=window), jq, jk, jv)
    for a, r in zip(mine, vjp(jdo)):
        np.testing.assert_allclose(_np(a), np.asarray(r).transpose(0, 2, 1, 3), atol=1e-5)


def test_flash_attention_function_cpu_path_is_plain_autograd():
    b, h, kv, s, d, dv = 2, 4, 2, 40, 16, 16
    q, k, v, do = (torch.tensor(x) for x in _qkv(b, h, kv, s, d, dv, 9))
    before = dict(fa.LAUNCHES)
    for causal, window in ((True, 0), (True, 9), (False, 0)):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        y = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*x, causal=causal, window=window)
        ref = fa.flash_attention_plain(*y, causal=causal, window=window)
        assert torch.equal(out, ref)
        for a, r in zip(torch.autograd.grad(out, x, do), torch.autograd.grad(ref, y, do)):
            np.testing.assert_allclose(_np(a), _np(r), atol=1e-6)
    with torch.no_grad():  # no gradient wanted: the serve path's call
        assert torch.equal(ops.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))
    assert fa.LAUNCHES == before  # plain versions count no launches


# ---------------------------------------------------------------------------
# LM.loss, the train step, the driver
# ---------------------------------------------------------------------------


def _models(n_layers=2):
    jcfg = jget_config("smollm-135m").reduced(n_layers=n_layers)
    cfg = get_config("smollm-135m").reduced(n_layers=n_layers)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (jcfg.n_layers, jcfg.d_model,
                                                          jcfg.vocab_size)
    jm = JLM(jcfg, RULES)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                          device="cpu")
    return jm, jp, LM(cfg), tp


def _batch(cfg_vocab, b=4, s=32, seed=2):
    nxt = next(TokenStream(cfg_vocab, b, s, seed=seed))
    return ({k: jnp.asarray(v) for k, v in nxt.items()},
            {k: torch.from_numpy(v) for k, v in nxt.items()})


def _port_grads(model, params, batch, n_clients=2):
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, metrics = model.loss(live, batch, n_clients)
    paths, leaves = tree_flatten_with_paths(live)
    return loss, metrics, dict(zip(paths, torch.autograd.grad(loss, leaves, allow_unused=True)))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_lm_loss_and_grads_match_reference(n_layers):
    jm, jp, tm, tp = _models(n_layers)
    jb, tb = _batch(tm.cfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, 2), has_aux=True))(jp)
    tl, tmet, grads = _port_grads(tm, tp, tb)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    for key in ("ce", "aux", "mmd"):
        assert abs(float(tmet[key].detach()) - float(jmet[key])) <= 1e-4 * max(
            1.0, abs(float(jmet[key])))
    assert float(tmet["mmd"].detach()) > 0
    ref = _leaves(jg)
    assert sorted(ref) == sorted(grads)
    nudge = dict.fromkeys(grads, 0.0)
    if n_layers > 1:  # the stack's own fp32 conditioning (module docstring)
        gen = torch.Generator().manual_seed(1)
        _, _, moved = _port_grads(tm, tree_map(
            lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)), tp), tb)
        nudge = {k: 0.0 if g is None else _rel(_np(moved[k]), _np(g)) for k, g in grads.items()}
    for path, g in grads.items():
        if path == "fda/omega":  # frozen: no gradient reaches it (tests/test_models.py:181)
            assert g is None and float(np.abs(ref[path]).sum()) == 0.0
            continue
        assert _rel(_np(g), ref[path]) <= 1e-4 + 4 * nudge[path], (path, nudge[path])
    assert float(grads["fda/w_rf"].abs().sum()) > 0


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` checkpoints each layer: the same loss; the gradients
    summed over the stacked layers in another order (1e-6 of max(1,
    max|leaf|))."""
    cfg = get_config("smollm-135m").reduced()
    params = LM(cfg).init(0, device="cpu")
    _, tb = _batch(cfg.vocab_size)
    before = dict(fa.LAUNCHES)
    l0, _, g0 = _port_grads(LM(cfg), params, tb)
    l1, _, g1 = _port_grads(LM(dataclasses.replace(cfg, remat=True)), params, tb)
    assert float(l0) == float(l1)
    for k, g in g0.items():
        assert (g is None and g1[k] is None) or _rel(_np(g1[k]), _np(g)) <= 1e-6, k
    assert fa.LAUNCHES == before


def test_train_steps_match_reference():
    jm, jp, tm, tp = _models()
    lr = dict(base_lr=3e-4, warmup=10, total=30)
    jopt = joptim.adamw(joptim.cosine_schedule(**lr), weight_decay=0.01)
    topt = optim.adamw(optim.cosine_schedule(**lr), weight_decay=0.01)
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, 2))
    tstep = train.build_train_step(tm, topt, 2)
    js, ts = jopt.init(jp), topt.init(tp)
    ja, ta = JTokenStream(tm.cfg.vocab_size, 4, 32, seed=1), TokenStream(tm.cfg.vocab_size, 4,
                                                                          32, seed=1)
    lr_sum = 0.0
    sched = joptim.cosine_schedule(**lr)
    for step in range(1, 4):
        jb = {k: jnp.asarray(v) for k, v in next(ja).items()}
        tb = {k: torch.from_numpy(v) for k, v in next(ta).items()}
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        lr_sum += float(sched(jnp.int32(step)))
        for key in ("loss", "ce", "mmd"):
            assert abs(float(tmet[key]) - float(jmet[key])) <= 1e-4 * max(1.0, abs(float(
                jmet[key]))), key
        # the global norm is the embeddings' gradient's, which a 1e-7 nudge of
        # the weights moves by ~6e-4 of itself (module docstring)
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-3 * float(
            jmet["grad_norm"])
        ref = _leaves(jp)
        for path, leaf in _leaves(tp).items():
            scale = max(1.0, float(np.abs(ref[path]).max()))
            assert float(np.abs(leaf - ref[path]).max()) <= 1e-4 * scale + 2 * lr_sum, path
        np.testing.assert_array_equal(_leaves(tp)["fda/omega"], ref["fda/omega"])
    assert int(ts.step) == 3


def test_train_main_on_cpu_loss_decreases_and_resumes(tmp_path):
    """tests/test_launch.py's reduced run and rule, then a checkpoint resume."""
    flags = ["--arch", "smollm-135m", "--reduced", "--steps", "30", "--batch", "4", "--seq",
             "64", "--clients", "2", "--log-every", "30", "--device", "cpu"]
    out = train.main(flags)
    assert len(out["losses"]) == 30 and np.all(np.isfinite(out["losses"]))
    assert out["last"] < out["first"] + 0.5
    ck = str(tmp_path / "ck")
    short = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "16",
             "--log-every", "100", "--device", "cpu", "--ckpt", ck]
    first = train.main(short + ["--steps", "4"])
    assert len(first["losses"]) == 4
    resumed = train.main(short + ["--steps", "6"])
    assert len(resumed["losses"]) == 2  # steps 5 and 6 from the step-4 checkpoint
    assert np.all(np.isfinite(resumed["losses"]))


def test_fda_omega_stays_fixed_through_training():
    cfg = get_config("smollm-135m").reduced()
    model = LM(cfg)
    params = model.init(0, device="cpu")
    opt = optim.adamw(optim.cosine_schedule(3e-4, warmup=1, total=4), weight_decay=0.0)
    state = opt.init(params)
    step = train.build_train_step(model, opt, 2)
    omega0 = params["fda"]["omega"].clone()
    w0 = params["fda"]["w_rf"].clone()
    batch = {k: torch.from_numpy(v) for k, v in next(TokenStream(cfg.vocab_size, 4, 16)).items()}
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    assert torch.equal(params["fda"]["omega"], omega0)
    assert not torch.equal(params["fda"]["w_rf"], w0)
