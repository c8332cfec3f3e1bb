"""Port parity: cross-attention (repro_torch.models.attention's
``cross_attn_forward`` and ``image_kv``, the cross block) and the vlm and
audio families of repro_torch.models.LM against repro on the CPU.

The same numpy inputs go through both packages.  The VLM's gates are set to
0.5 and its images are seeded (normal x 0.1): at init a gate is 0, tanh(0)
makes every cross block an identity, and zero images (the reference serve
``main``'s) would leave the image path untested.  Tolerances:
``cross_attn_forward`` and ``image_kv`` 2e-5 at fp32 and 3e-2 x max(1,
max|x|) at bf16; the vlm and audio LMs (tiny ones and the
llama-3.2-vision-90b and musicgen-large ``reduced()`` configs), from the
reference's ``LM.init`` tree, under tests/torch_lm_parity.py's
``check_lm_fp32`` (forward 1e-4, prefill logits 1e-4, cache leaves 1e-4 x
max(1, max|leaf|), decode 1e-3); one bf16 VLM under ``check_lm_bf16``;
``LM.loss`` and every gradient leaf under ``check_loss_and_grads``
(tests/test_torch_train.py's nudge rule); greedy tokens of
``serve.generate`` equal to the reference's serve loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_parity import (  # noqa: E402
    VLM_GATE, both, check_lm_bf16, check_lm_fp32, check_loss_and_grads, close, cut, decls_match,
    inputs, mk, models, one_thread, port_config, reduced, serve_main, train_main,
)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.serve import grow_cache as jgrow_cache  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402

assert one_thread  # the module-scoped autouse fixture, imported to apply here
ARCHS = ("llama-3.2-vision-90b", "musicgen-large")
VLM_KW = dict(family="vlm", cross_attn_every=1, n_layers=3, n_image_tokens=8, d_image=32)


# ---------------------------------------------------------------------------
# cross-attention and the cross block on the same numpy weights
# ---------------------------------------------------------------------------

def _cross_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kv, hd, di = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_image
    out = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
           for k, shape in (("wq", (d, h, hd)), ("wk", (di, kv, hd)), ("wv", (di, kv, hd)),
                            ("wo", (h, hd, d)))}
    out["gate"] = np.float32(VLM_GATE)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_matches_reference(dtype):
    """``image_kv`` and ``cross_attn_forward`` (the tanh gate at 0.5), then
    the whole cross block (norms, gated cross-attention, MLP) on the same
    weights."""
    rc = mk(**VLM_KW, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    cfg = port_config(rc)
    w = _cross_weights(cfg, 1)
    jw = {k: both(v, dtype)[0] for k, v in w.items()}
    tw = {k: both(v, dtype)[1] for k, v in w.items()}
    rng = np.random.default_rng(2)
    jimg, timg = both((rng.standard_normal((2, 8, 32)) * 0.1).astype(np.float32), dtype)
    jx, tx = both(rng.standard_normal((2, 10, 64)).astype(np.float32), dtype)
    atol, rel = (2e-5, False) if dtype == "f32" else (3e-2, True)
    kv, tkv = jattn.image_kv(jw, jimg), tattn.image_kv(tw, timg)
    for a, b in zip(tkv, kv):
        close(a, b, atol, rel_to_max=rel, what="image kv")
    out = jattn.cross_attn_forward(jw, jx, kv, rc)
    tout = tattn.cross_attn_forward(tw, tx, tkv, cfg)
    assert tout.dtype == cfg.dtype and float(tout.abs().max()) > 0
    close(tout, out, atol, rel_to_max=rel, what="cross attention")
    f = np.random.default_rng(3)
    mlp = {k: (f.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in (("gate", (64, 128)), ("up", (64, 128)), ("down", (128, 64)))}
    norms = {k: {"scale": (1 + 0.1 * f.standard_normal(64)).astype(np.float32)}
             for k in ("ln_x", "ln_mlp")}
    jp = {"xattn": jw, "mlp": {k: both(v, dtype)[0] for k, v in mlp.items()},
          **{k: {"scale": both(v["scale"], dtype)[0]} for k, v in norms.items()}}
    tp = {"xattn": tw, "mlp": {k: both(v, dtype)[1] for k, v in mlp.items()},
          **{k: {"scale": both(v["scale"], dtype)[1]} for k, v in norms.items()}}
    close(tblocks.cross_block_forward(tp, tx, tkv, cfg),
          jblocks.cross_block_forward(jp, jx, kv, rc), 1e-4 if dtype == "f32" else 3e-2,
          rel_to_max=True, what="cross block")


def test_zero_gate_makes_the_cross_block_its_mlp():
    """At init (gate 0) the cross-attention adds nothing, as in the reference."""
    cfg = port_config(mk(**VLM_KW))
    params = LM(cfg).init(0, device="cpu")["cross_blocks"]
    cp = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params.items()}
    assert float(cp["xattn"]["gate"]) == 0.0 and cp["xattn"]["gate"].dim() == 0
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(0))
    kv = tattn.image_kv(cp["xattn"], torch.randn((2, 8, 32)))
    assert float(tattn.cross_attn_forward(cp["xattn"], x, kv, cfg).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the vlm and audio LMs: the reference's weights through both packages
# ---------------------------------------------------------------------------

CONFIGS = {
    # two self layers around one cross layer: one group of one and a remainder of one
    "vlm": lambda **kw: mk(**{**VLM_KW, **kw}),
    "audio": lambda **kw: mk(**{**dict(family="audio", embeddings_in=True), **kw}),
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
    check_lm_bf16(CONFIGS["llama-3.2-vision-90b-reduced"]())


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b-reduced", "musicgen-large-reduced"])
def test_lm_loss_and_grads_match_reference(name):
    check_loss_and_grads(CONFIGS[name]())


@pytest.mark.parametrize("name", ["vlm", "audio"])
def test_generate_matches_reference_serve_loop(name):
    """``serve.generate`` against the reference's serve loop (prefill,
    ``grow_cache``, argmax decode) at fp32: the VLM feeds its tokens back,
    the audio model the frames ``generate`` draws, fed to the reference too."""
    jm, jp, tm, tp = models(CONFIGS[name]())
    b, s, gen = 3, 10, 6
    vocab = tm.cfg.vocab_size
    jb, tb = cut(inputs(tm.cfg, b, s, seed=3), 0, s)
    res = serve.generate(tm, tp, tb, gen)
    frames = torch.randn((gen - 1, b, 1, tm.cfg.d_model),
                         generator=torch.Generator().manual_seed(serve.FRAME_SEED)) * 0.02
    logits, cache = jax.jit(jm.prefill)(jp, jb)
    cache = jgrow_cache(cache, gen)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, :vocab], axis=-1)[:, None]
    ref = [np.asarray(tok)]
    for i in range(gen - 1):
        step = ({"embeddings": jnp.asarray(frames[i].numpy())} if tm.cfg.embeddings_in
                else {"tokens": tok})
        logits, cache = decode(jp, cache, step, jnp.int32(s + i))
        close(res["logits"][i + 1], logits, 1e-3, what=f"step {i}")
        tok = jnp.argmax(logits[:, :vocab], axis=-1)[:, None]
        ref.append(np.asarray(tok))
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(ref, axis=1))


@pytest.mark.parametrize("name", ["vlm", "audio"])
def test_port_decode_matches_forward(name):
    """tests/test_models.py:124-138 on the port's own weights, from
    ``init_cache``'s zeros (the VLM's image K/V from a prefill of the first
    token: a decode step reads them from the cache)."""
    cfg = port_config(CONFIGS[name]())
    model = LM(cfg)
    params = model.init(0, device="cpu")
    if cfg.family == "vlm":
        params["cross_blocks"]["xattn"]["gate"].fill_(VLM_GATE)
    b, s = 2, 12
    data = {k: torch.tensor(v) for k, v in inputs(cfg, b, s, seed=4).items() if k != "labels"}
    full = model.logits(params, model.forward(params, data)[0])
    seq = "embeddings" if cfg.embeddings_in else "tokens"
    if cfg.family == "vlm":
        _, cache = model.prefill(params, {seq: data[seq][:, :1], "images": data["images"]})
        cache = serve.grow_cache(cache, s - 1)
        first = 1
    else:
        cache, first = model.init_cache(b, s, device="cpu"), 0
    for t in range(first, s):
        logits, cache = model.decode_step(params, cache, {seq: data[seq][:, t:t + 1]}, t)
        assert float((logits - full[:, t]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    serve_main(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_on_cpu(arch):
    train_main(arch)


def test_full_configs_cache_shapes():
    """llama-3.2-vision-90b at full size (80 self and 20 cross layers; its
    image K/V are not grown) and at phase 17's cut to 5 layers (4 self, 1
    cross); musicgen-large's decoder cache."""
    vm = LM(get_config("llama-3.2-vision-90b"))
    assert vm.cache_shapes(4, 2064) == {
        "layers": {"k": (80, 4, 2064, 8, 128), "v": (80, 4, 2064, 8, 128)},
        "img_k": (20, 4, 576, 8, 128), "img_v": (20, 4, 576, 8, 128)}
    cut5 = LM(get_config("llama-3.2-vision-90b").reduced(
        **{f: getattr(get_config("llama-3.2-vision-90b"), f) for f in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
            "cross_attn_every", "n_image_tokens", "d_image")}, n_layers=5))
    assert [k for k, _ in cut5.schedule()] == ["block"] * 4 + ["cross"]
    um = LM(get_config("musicgen-large"))
    assert um.cache_shapes(4, 1516) == {"layers": {"k": (48, 4, 1516, 32, 64),
                                                   "v": (48, 4, 1516, 32, 64)}}
    assert set(um.decls()["embedding"]) == {"unembed"}
