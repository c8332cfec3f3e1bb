"""The port's dry run (repro_torch.launch.dryrun, roofline_sweep) on meta
tensors, on the CPU, held to analytic counts.

- smollm-135m at its full width cut to two layers, at train_4k (AdamW,
  clipping, remat), prefill_32k and decode_32k: every tensor the step
  creates is on the ``meta`` device, and the products counted from the
  dispatched operations equal the analytic sum of the model's products
  exactly; K11's and K11b's reported work equals their band formula
  (``kernels.flash_attention.forward_cost`` / ``backward_cost``) at the
  model's shapes, call for call.
- Every arch at long_500k, the MoE and SSM combos among them; MLA's decode
  past its (windowed) cache writes at the last slot, as the reference's
  ``dynamic_update_slice`` clamps, equal to the reference's to 2e-5.
- ``sweep_combo``'s two-depth extrapolation against a full-depth count:
  smollm-135m (a uniform stack) at train_4k within a relative 1e-9, and
  zamba2-7b (the hybrid) at train_4k within the reference's stated 2%.
  (At zamba2's full depth of 81 the extrapolation misses by more at the
  other shapes, 2.8% of the products at prefill_32k: PERF.md.)
- The CLI in process on one combo: the record has the reference's keys but
  its compile and lower times (read from ``repro/launch/dryrun.py``'s
  source), and ``--mesh single`` raises naming the ROADMAP item.
"""
import ast
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun, roofline_sweep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's host work: the suite runs in parallel
    workers, where each one's pools would contend for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class OnlyMeta(TorchDispatchMode):
    """Raises on any operation that makes a tensor off the meta device."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


def _layer_products(cfg, t: int) -> int:
    """Forward products of one dense decoder layer over t tokens."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    return 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 2 * t * 3 * d * f


def _analytic(cfg, shape, layers: int) -> int:
    b, s, v = shape.global_batch, shape.seq_len, cfg.vocab_padded
    d = cfg.d_model
    if shape.kind == "prefill":  # the layers, then the last token's logits
        return layers * _layer_products(cfg, b * s) + 2 * b * d * v
    if shape.kind == "decode":  # one token against an s-long cache
        attn = 2 * 2 * b * cfg.n_heads * cfg.hd * s
        return layers * (_layer_products(cfg, b) + attn) + 2 * b * d * v
    # train: remat runs each layer's forward twice, but the recompute stops
    # at the last tensor the backward needs (torch.utils.checkpoint's early
    # stop), so the MLP's down projection runs once; the backward is two
    # products a product; the logits and the FDA head once forward, twice
    # backward (the head's Omega is frozen: no weight gradient for it)
    t, n, m, nc = b * s, cfg.fda_n_rff, cfg.fda_m, 2
    layer = 4 * _layer_products(cfg, t) - 2 * t * cfg.d_ff * d
    head = 3 * 2 * t * d * v
    fda = 2 * b * d * n + 2 * b * n * d + 3 * 2 * nc * 2 * n * m
    return layers * layer + head + fda


def _attention_calls(cfg, shape, layers):
    """(forward calls with lse, forward calls without, backward calls) and
    the K11 shape."""
    kshape = (shape.global_batch, cfg.n_heads, cfg.n_kv_heads, shape.seq_len, cfg.hd, cfg.hd)
    if shape.kind == "train":  # the forward and its remat recompute (both with lse), the backward
        return (2 * layers, 0, layers), kshape
    if shape.kind == "prefill":
        return (0, layers, 0), kshape
    return (0, 0, 0), kshape


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_dry_run_counts_the_analytic_products(shape_name):
    shape, layers = INPUT_SHAPES[shape_name], 2
    cfg = get_config("smollm-135m")
    guard = OnlyMeta()
    with guard:
        rec, count = dryrun.lower_combo("smollm-135m", shape_name, depth=layers)
    assert guard.ops >= count.ops > 0  # the guard also sees the arguments made
    assert count.flops == _analytic(cfg, shape, layers)
    (with_lse, plain, bwd), kshape = _attention_calls(cfg, shape, layers)
    fwd = fa.forward_cost(kshape, cfg.dtype, True, 0)
    fwd_lse = fa.forward_cost(kshape, cfg.dtype, True, 0, return_lse=True)
    bwd_cost = fa.backward_cost(kshape, cfg.dtype, True, 0)
    k11, k11b = count.kernels["flash_attention"], count.kernels["flash_attention_bwd"]
    assert k11["calls"] == with_lse + plain and k11b["calls"] == bwd
    assert k11["flops"] == with_lse * fwd_lse[0] + plain * fwd[0]
    assert k11["bytes"] == with_lse * fwd_lse[1] + plain * fwd[1]
    assert (k11b["flops"], k11b["bytes"]) == (bwd * bwd_cost[0], bwd * bwd_cost[1])
    assert rec["roofline"]["flops_per_chip"] == count.flops + k11["flops"] + k11b["flops"]
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] >= 0
    if shape.kind == "decode":  # the cache is written in place
        assert mem["alias_bytes"] == 2 * layers * 2 * shape.global_batch * shape.seq_len * (
            cfg.n_kv_heads * cfg.hd)


def test_band_formula():
    """``band_pairs`` against a count of the kept mask's entries."""
    for s in (1, 5, 64, 77):
        for causal in (True, False):
            for window in (0, 1, 3, 48, 100):
                keep = fa._keep_mask(s, causal, window, "cpu")
                assert fa.band_pairs(s, causal, window) == int(keep.sum()), (s, causal, window)
    assert fa.forward_cost((1, 2, 1, 4, 8, 8), torch.bfloat16)[0] == 2 * 2 * 10 * 16
    assert fa.FlashAttention.cost((1, 2, 1, 4, 8, 8), torch.float32) == tuple(
        a + b for a, b in zip(fa.forward_cost((1, 2, 1, 4, 8, 8), torch.float32,
                                              return_lse=True),
                              fa.backward_cost((1, 2, 1, 4, 8, 8), torch.float32)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_at_long_500k(arch):
    """Each family's decode step at long_500k (a 4096-token window cache, or
    the SSM's state) on meta tensors, at its first probe depth: no host
    read, nothing off meta."""
    with OnlyMeta():
        rec, count = dryrun.lower_combo(arch, "long_500k",
                                        depth=roofline_sweep.probe_depths(arch)[0])
    r = rec["roofline"]
    assert rec["kind"] == "decode" and rec["mesh"] == "card"
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
    assert r["coll_bytes_per_chip"] == 0  # one card: no collectives
    assert rec["memory"]["alias_bytes"] > 0  # the decode step writes its cache in place


def test_sweep_extrapolation_matches_full_depth_count_uniform():
    probe = roofline_sweep.sweep_combo("smollm-135m", "train_4k")["roofline"]
    exact = roofline_sweep.sweep_combo("smollm-135m", "train_4k", probe=False)["roofline"]
    for key in ("flops_per_chip", "hbm_bytes_per_chip"):
        assert abs(probe[key] / exact[key] - 1) <= 1e-9, key


def test_sweep_extrapolation_within_two_percent_hybrid():
    probe = roofline_sweep.sweep_combo("zamba2-7b", "train_4k")["roofline"]
    exact = roofline_sweep.sweep_combo("zamba2-7b", "train_4k", probe=False)["roofline"]
    for key in ("flops_per_chip", "hbm_bytes_per_chip"):
        assert abs(probe[key] / exact[key] - 1) <= 0.02, key


def _reference_record_keys() -> set:
    """The keys of ``record`` in repro/launch/dryrun.py's ``lower_combo``."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in the reference's dryrun.py")


def test_cli_writes_the_reference_record_keys(tmp_path):
    recs = dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out",
                        str(tmp_path)])
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_card.json").read_text())
    assert set(rec) == _reference_record_keys() - {"compile_s", "lower_s"}
    assert rec == json.loads(json.dumps(recs[0]))
    assert rec["kind"] == "decode" and rec["roofline"]["flops_per_chip"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == []  # exists: skipped without --force
    for mesh in ("single", "multi"):
        with pytest.raises(ValueError, match="LM tensor and data parallelism"):
            dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", mesh,
                         "--out", str(tmp_path)])


def test_mla_decode_past_its_cache_clamps_like_reference():
    """deepseek-v2-lite's long_500k combo decodes at position 524287 into a
    4096-slot cache: the reference's ``dynamic_update_slice`` clamps the
    write to the last slot, and the port writes there too (no IndexError)."""
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as jget_config
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg = jget_config("deepseek-v2-lite-16b").reduced()
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    rng = np.random.default_rng(0)
    d, h, hd, r, rd = cfg.d_model, cfg.n_heads, cfg.hd, cfg.kv_lora_rank, cfg.rope_head_dim
    shapes = {"wq_nope": (d, h, hd), "wq_rope": (d, h, rd), "w_dkv": (d, r),
              "w_krope": (d, rd), "w_uk": (r, h, hd), "w_uv": (r, h, hd), "wo": (h, hd, d)}
    w = {k: (rng.normal(size=v) / np.sqrt(v[0])).astype(np.float32) for k, v in shapes.items()}
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    c = rng.normal(size=(2, 8, r)).astype(np.float32)
    kr = rng.normal(size=(2, 8, rd)).astype(np.float32)
    pos = 40  # past the 8-slot cache
    jo, jc, jkr = jattn.mla_decode({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                                   jnp.asarray(c), jnp.asarray(kr), pos, jcfg)
    to, tc, tkr = tattn.mla_decode({k: torch.tensor(v) for k, v in w.items()}, torch.tensor(x),
                                   torch.tensor(c), torch.tensor(kr), pos, cfg)
    for a, b in ((to, jo), (tc, jc), (tkr, jkr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tc[:, :7].numpy(), c[:, :7])  # only the last slot written
