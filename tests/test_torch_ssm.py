"""Port parity: Mamba2/SSD (repro_torch.models.ssm, the SSM blocks) and the
ssm and hybrid families of repro_torch.models.LM against repro on the CPU.

The same numpy inputs go through both packages.  Tolerances:
``ssd_chunked`` 2e-5 x max(1, max|ref|) on y and the final state (chunks 8,
16, 64 and a ragged s that halves the chunk); the port's ``ssd_chunked``
against its own ``ssm_ref_sequential`` 1e-3 (tests/test_models.py:51-62);
``ssm_forward`` (with its state) and ``ssm_decode`` 1e-4 x max(1, max|x|)
at fp32, 3e-2 x max(1, max|x|) at bf16; the ssm and hybrid LMs of
tests/test_models.py:119-120 and mamba2-2.7b's and zamba2-7b's ``reduced()``
configs, from the reference's ``LM.init`` tree, under
tests/torch_lm_parity.py's ``check_lm_fp32`` (forward 1e-4, prefill logits
1e-4, cache leaves 1e-4 x max(1, max|leaf|), decode 1e-3); one bf16 SSM LM
under ``check_lm_bf16``; ``LM.loss`` and every gradient leaf under
``check_loss_and_grads`` (tests/test_torch_train.py's nudge rule).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_parity import (  # noqa: E402
    RULES, both, check_lm_bf16, check_lm_fp32, check_loss_and_grads, close, decls_match, mk,
    one_thread, port_config, port_grads, reduced, rel, serve_main, to_np, train_main,
)

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

assert one_thread  # the module-scoped autouse fixture, imported to apply here
ARCHS = ("mamba2-2.7b", "zamba2-7b")
SSM_KW = dict(ssm_state=16, ssm_head_dim=16, ssm_chunk=8, d_ff=0)  # tests/test_models.py:119


# ---------------------------------------------------------------------------
# the chunked SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, seed):
    """tests/test_models.py:52-58's distributions from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = rng.uniform(0.0, 1.0, (h,)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("s,chunk", [(64, 8), (64, 16), (64, 64), (48, 32)],
                         ids=["chunk8", "chunk16", "chunk64", "ragged48-halves-32"])
def test_ssd_chunked_matches_reference(s, chunk):
    arrs = _ssd_inputs(2, s, 3, 8, 16, seed=s + chunk)
    jy, jfinal = jax.jit(jssm.ssd_chunked, static_argnums=5)(*(jnp.asarray(a) for a in arrs),
                                                              chunk)
    ty, tfinal = tssm.ssd_chunked(*(torch.tensor(a) for a in arrs), chunk)
    assert tssm.chunk_len(chunk, s) == (16 if s == 48 else chunk)
    close(ty, jy, 2e-5, rel_to_max=True, what="y")
    close(tfinal, jfinal, 2e-5, rel_to_max=True, what="final state")
    assert tfinal.dtype == torch.float32


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_own_sequential(chunk):
    """The port's chunked scan against its own recurrence: y (1e-3,
    tests/test_models.py:61) and the final state (tests/test_models.py:65-82)."""
    x, dt, a_log, bb, cc = (torch.tensor(a) for a in _ssd_inputs(2, 64, 3, 8, 16, seed=chunk))
    y, final = tssm.ssd_chunked(x, dt, a_log, bb, cc, chunk)
    y_ref, state = tssm.ssm_ref_sequential(x, dt, a_log, bb, cc)
    close(y, y_ref, 1e-3, what="y")
    close(final, state, 1e-3, what="final state")
    jy = jax.jit(jssm.ssm_ref_sequential)(*(jnp.asarray(t.numpy()) for t in (x, dt, a_log, bb,
                                                                             cc)))
    close(y_ref, jy, 2e-5, rel_to_max=True, what="the recurrences")


# ---------------------------------------------------------------------------
# ssm_forward and ssm_decode on the same numpy weights
# ---------------------------------------------------------------------------

def _ssm_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, di, n, h, w = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_conv_width
    out = {k: (rng.standard_normal(shape) * scale / np.sqrt(shape[-2])).astype(np.float32)
           for k, shape, scale in (("w_z", (d, di), 1), ("w_x", (d, di), 1), ("w_b", (d, n), 1),
                                   ("w_c", (d, n), 1), ("w_dt", (d, h), 1), ("w_out", (di, d), 1),
                                   ("conv_x", (w, di), 0.5), ("conv_b", (w, n), 0.5),
                                   ("conv_c", (w, n), 0.5))}
    out["dt_bias"] = np.log(np.expm1(rng.uniform(1e-3, 1e-1, (h,)))).astype(np.float32)
    out["a_log"] = np.log(rng.uniform(1.0, 16.0, (h,))).astype(np.float32)
    out["d_skip"] = rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    out["norm"] = (1 + 0.1 * rng.standard_normal((di,))).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_forward_and_decode_match_reference(dtype):
    """A prefill of 16 tokens with its decode state, then 4 decode steps from
    each package's own state: outputs and both state leaves ("ssm" fp32,
    "conv" in the config dtype) agree."""
    rc = mk(family="ssm", **SSM_KW, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    cfg = port_config(rc)
    w = _ssm_weights(cfg, 3)
    fp32_leaves = ("dt_bias", "a_log", "d_skip")
    jw = {k: both(v, "f32" if k in fp32_leaves else dtype)[0] for k, v in w.items()}
    tw = {k: both(v, "f32" if k in fp32_leaves else dtype)[1] for k, v in w.items()}
    tol = 1e-4 if dtype == "f32" else 3e-2
    x = np.random.default_rng(4).standard_normal((2, 20, 64)).astype(np.float32)
    jx, tx = both(x, dtype)
    out, state = jax.jit(lambda p, x: jssm.ssm_forward(p, x, rc, return_state=True))(
        jw, jx[:, :16])
    decode = jax.jit(lambda p, x, st: jssm.ssm_decode(p, x, st, rc))
    tout, tstate = tssm.ssm_forward(tw, tx[:, :16], cfg, return_state=True)
    assert tout.dtype == cfg.dtype and tstate["ssm"].dtype == torch.float32
    assert tstate["conv"].dtype == cfg.dtype
    close(tout, out, tol, rel_to_max=True, what="prefill")
    for k in ("ssm", "conv"):
        close(tstate[k], state[k], tol, rel_to_max=True, what=f"prefill state {k}")
    for t in range(16, 20):
        o, state = decode(jw, jx[:, t:t + 1], state)
        to, tstate2 = tssm.ssm_decode(tw, tx[:, t:t + 1], tstate, cfg)
        assert tstate2 is tstate and tstate["ssm"].dtype == torch.float32  # in place, fp32
        close(to, o, tol, rel_to_max=True, what=f"decode {t}")
        for k in ("ssm", "conv"):
            close(tstate[k], state[k], tol, rel_to_max=True, what=f"decode {t} state {k}")


def test_ssm_block_prefill_handoff_matches_forward():
    """The port's own block: a prefill of 12 tokens and 4 decode steps equal
    its forward over 16 (tests/test_models.py:141-161), the conv tail and the
    fp32 state handing over; a prompt shorter than the conv's width leaves
    zeros in front of its tail, as decoding from an empty cache does."""
    cfg = port_config(mk(family="ssm", **SSM_KW))
    params = LM(cfg).init(0, device="cpu")["blocks"]
    layer = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params.items()}
    x = torch.tensor(np.random.default_rng(5).standard_normal((2, 16, 64)).astype(np.float32))
    full, _ = tblocks.ssm_block_forward(layer, x, cfg)
    y, _, cache = tblocks.ssm_block_forward(layer, x[:, :12], cfg, collect_cache=True)
    close(y, full[:, :12], 1e-4, rel_to_max=True, what="prefill")
    for t in range(12, 16):
        yt, cache = tblocks.ssm_block_decode(layer, x[:, t:t + 1], cache, cfg)
        close(yt, full[:, t:t + 1], 1e-3, rel_to_max=True, what=f"decode {t}")
    _, _, short = tblocks.ssm_block_forward(layer, x[:, :2], cfg, collect_cache=True)
    empty = LM(cfg).init_cache(2, 1, device="cpu")["layers"]
    state = {k: v[0].clone() for k, v in empty.items()}
    for t in range(2):
        _, state = tblocks.ssm_block_decode(layer, x[:, t:t + 1], state, cfg)
    close(short["conv"], state["conv"], 1e-6, what="short prompt's conv tail")
    close(short["ssm"], state["ssm"], 1e-4, rel_to_max=True, what="short prompt's state")


# ---------------------------------------------------------------------------
# the ssm and hybrid LMs: the reference's weights through both packages
# ---------------------------------------------------------------------------

CONFIGS = {
    # tests/test_models.py:119-120
    "ssm": lambda **kw: mk(**{**dict(family="ssm", **SSM_KW), **kw}),
    "hybrid": lambda **kw: mk(**{**dict(family="hybrid", attn_every=1, **SSM_KW), **kw}),
    # two groups of two Mamba2 layers and a remainder of one
    "hybrid-remainder": lambda **kw: mk(**{**dict(family="hybrid", attn_every=2, n_layers=5,
                                                  **SSM_KW), **kw}),
    **{f"{arch}-reduced": reduced(arch) for arch in ARCHS},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_decls_match_reference(arch):
    decls_match(jget_config(arch))
    decls_match(jget_config(arch).reduced())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_matches_reference_fp32(name):
    check_lm_fp32(CONFIGS[name]())


def test_lm_matches_reference_bf16():
    check_lm_bf16(CONFIGS["mamba2-2.7b-reduced"]())


@pytest.mark.parametrize("name", ["mamba2-2.7b-reduced", "zamba2-7b-reduced"])
def test_lm_loss_and_grads_match_reference(name):
    check_loss_and_grads(CONFIGS[name]())


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` checkpoints each Mamba2 layer and the shared attention:
    the same loss and gradients (1e-6 of max(1, max|leaf|))."""
    cfg = port_config(CONFIGS["hybrid-remainder"]())
    params = LM(cfg).init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(6).integers(0, 97, (4, 16)))
    batch = {"tokens": toks, "labels": toks}
    l0, _, g0 = port_grads(LM(cfg), params, batch)
    l1, _, g1 = port_grads(LM(dataclasses.replace(cfg, remat=True)), params, batch)
    assert float(l0.detach()) == float(l1.detach())
    for k, g in g0.items():
        assert (g is None and g1[k] is None) or rel(to_np(g1[k]), to_np(g)) <= 1e-6, k


@pytest.mark.parametrize("name", ["ssm", "hybrid-remainder"])
def test_port_decode_matches_forward(name):
    """tests/test_models.py:124-138 on the port's own weights, from
    ``init_cache``'s zeros (the SSM state in fp32)."""
    cfg = port_config(CONFIGS[name]())
    model = LM(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 16
    toks = torch.tensor(np.random.default_rng(7).integers(0, 97, (b, s)))
    full = model.logits(params, model.forward(params, {"tokens": toks})[0])
    cache = model.init_cache(b, s, device="cpu")
    assert cache["layers"]["ssm"].dtype == torch.float32
    assert cache["layers"]["conv"].dtype == cfg.dtype
    for t in range(s):
        logits, cache = model.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t)
        assert float((logits - full[:, t]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    serve_main(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_on_cpu(arch):
    train_main(arch)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_full_configs_param_count_matches_reference(arch):
    """Every architecture builds at full size (decls only) with the
    reference's parameter count."""
    assert LM(get_config(arch)).param_count() == JLM(jget_config(arch), RULES).param_count()


def test_full_configs_cache_shapes():
    """mamba2-2.7b's and zamba2-7b's decode caches at full size, and
    zamba2-7b's 81 layers as 13 groups of 6 plus 3."""
    m = LM(get_config("mamba2-2.7b")).cache_shapes(4, 2064)
    assert m == {"layers": {"ssm": (64, 4, 80, 64, 128), "conv": (64, 4, 3, 5376)}}
    zm = LM(get_config("zamba2-7b"))
    assert zm.cache_shapes(4, 2064) == {
        "layers": {"ssm": (81, 4, 112, 64, 64), "conv": (81, 4, 3, 7296)},
        "attn_k": (13, 4, 2064, 32, 112), "attn_v": (13, 4, 2064, 32, 112)}
    sched = zm.schedule()
    assert [i for kind, i in sched if kind == "attn"] == list(range(13))
    assert len(sched) == 81 + 13 and sched[-4:] == [("attn", 12), ("block", 78), ("block", 79),
                                                     ("block", 80)]
