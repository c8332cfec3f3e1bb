"""The LM's placements and the dry run on the reference's production meshes.

- ``LM(cfg, ShardRules(M, batch_axes)).specs()`` and ``cache_specs()``
  equal the reference's ``PartitionSpec`` trees (as tuples) for every
  architecture of ``repro_torch.configs``, at model sizes 16, 2 and 3 and
  with the batch axes ("data",) and ("pod", "data").
- ``launch.dryrun`` at ``--mesh single`` (and ``multi``): rank 0's step of
  the (16, 16) mesh over a fake process group of 256 ranks (512 for (2, 16,
  16)), on meta tensors, nothing off meta.  smollm-135m at its full width
  cut to two layers, at train_4k, prefill_32k, decode_32k and long_500k:
  the per-card products equal the analytic sharded sum (9 heads: attention
  replicated at 16; d_ff 1536, the vocabulary 49152 and d 576 sharded) and
  the per-card collective bytes by kind equal the analytic count; K11 and
  K11b at the whole head counts.  Every architecture's probe-depth
  train_4k step runs under ``--mesh single`` with all-reduces and
  all-gathers counted, and under ``seq_parallel`` reduce-scatters too.
- ``roofline.count_step`` counts the functional collectives
  (``_c10d_functional``) by kind, per card.
"""
import contextlib
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ShardRules as JRules  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun, roofline, roofline_sweep  # noqa: E402
from repro_torch.launch.mesh import fake_production_mesh  # noqa: E402
from repro_torch.models import LM, ShardRules  # noqa: E402

BATCH_AXES = (("data",), ("pod", "data"))
LAYERS = 2
BF16, F32 = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _as_tuples(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


@pytest.mark.parametrize("model_size", [16, 2, 3])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_cache_specs_equal_the_reference(arch, model_size):
    for axes in BATCH_AXES:
        ref = JLM(jget_config(arch), JRules(model_size=model_size, batch_axes=axes))
        port = LM(get_config(arch), ShardRules(model_size=model_size, batch_axes=axes))
        assert port.specs() == _as_tuples(ref.specs()), (arch, model_size, axes)
        assert port.cache_specs() == _as_tuples(ref.cache_specs()), (arch, model_size, axes)


class OnlyMeta(TorchDispatchMode):
    """Raises on any operation that makes a tensor off the meta device, but
    while ``DeviceMesh`` lays out the fake group's ranks (host tensors)."""

    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not OnlyMeta.paused:
                assert t.device.type == "meta", (func, t.device)
        return out


@pytest.fixture(autouse=True)
def _mesh_layout_on_the_host(monkeypatch):
    real = dryrun.fake_production_mesh

    @contextlib.contextmanager
    def mesh(**kw):
        OnlyMeta.paused = True
        with real(**kw) as dm:
            OnlyMeta.paused = False
            yield dm

    monkeypatch.setattr(dryrun, "fake_production_mesh", mesh)


def _analytic(shape_name: str, multi: bool) -> tuple[int, dict]:
    """(products, collective bytes by kind) of one card's step of
    smollm-135m at two layers on the production mesh (model axis 16, data
    16 or 2 x 16).  The model axis shards d_ff, the vocabulary and the
    embedding's d; 9 and 3 heads stay whole (the block replicated)."""
    cfg, shape = get_config("smollm-135m"), INPUT_SHAPES[shape_name]
    d, h, kv, hd, m = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 16
    f, v = cfg.d_ff // m, cfg.vocab_padded // m
    data = 32 if multi else 16
    axes = 2 if multi else 1  # a sum over the data axes is an all-reduce over each
    b, s = shape.global_batch, shape.seq_len

    def layer(t):  # forward products of a layer over t tokens
        return 2 * t * d * hd * (2 * h + 2 * kv) + 2 * t * 3 * d * f

    kinds = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0, "all_to_all": 0}
    if shape.kind == "prefill":
        bl = b // data
        t = bl * s
        # the embedding's gather, each MLP's reduce, the last logits' gather
        kinds["all_gather"] = t * d * BF16 + bl * cfg.vocab_padded * BF16
        kinds["all_reduce"] = LAYERS * t * d * BF16
        return LAYERS * layer(t) + 2 * bl * d * v, kinds
    if shape.kind == "decode":
        over_data = b % data != 0  # long_500k: the cache's sequence over the data axes
        bl = b if over_data else b // data
        s_cache = min(s, 4096) if shape.name == "long_500k" else s
        s_loc = s_cache // data if over_data else s_cache
        attn = 2 * 2 * bl * h * hd * s_loc
        kinds["all_gather"] = bl * d * BF16 + bl * cfg.vocab_padded * BF16
        kinds["all_reduce"] = LAYERS * bl * d * BF16
        if over_data:  # the softmax's max, sum (fp32) and weighted values (bf16) a layer
            kinds["all_reduce"] += axes * LAYERS * (2 * bl * h * F32 + bl * h * hd * BF16)
        return LAYERS * (layer(bl) + attn) + 2 * bl * d * v, kinds
    bl = b // data
    t = bl * s
    n, m_rff = cfg.fda_n_rff, cfg.fda_m
    # remat recomputes each layer but the MLP's down projection (and its reduce)
    products = (LAYERS * (4 * layer(t) - 2 * t * f * d) + 3 * 2 * t * d * v
                + 2 * bl * d * n + 2 * bl * n * d + 3 * 2 * 1 * 2 * n * m_rff)
    # the embedding's and the logits' gathers (the CE's first form gathers them whole)
    kinds["all_gather"] = t * d * BF16 + t * cfg.vocab_padded * BF16
    params = (2 * cfg.vocab_padded * d // m + d  # embed, unembed, ln_f
              + LAYERS * (2 * d + 2 * d * (h + kv) * hd + 3 * d * f)) * BF16
    params += (n * d + 2 * n * m_rff) * F32  # the FDA head
    kinds["all_reduce"] = (
        LAYERS * t * d * BF16  # each MLP's reduce
        + LAYERS * t * d * BF16 + t * d * BF16  # the backward of each MLP's and the logits' copy
        + axes * (F32 + F32  # the CE's and the MMD's sums over data
                  + 2 * 2 * n * F32  # the federation mean, and its gradient's
                  + params)  # the gradients summed over data
        + F32)  # the clip's sum of squares over model
    return products, kinds


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_mesh_dry_run_counts_the_analytic_sharded_step(shape_name, multi):
    mesh = "multi" if multi else "single"
    with OnlyMeta():
        rec, count = dryrun.lower_combo("smollm-135m", shape_name, mesh, depth=LAYERS)
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["n_chips"] == (512 if multi else 256)
    products, kinds = _analytic(shape_name, multi)
    assert count.flops == products
    assert count.coll_by_kind == kinds
    assert rec["roofline"]["coll_bytes_per_chip"] == sum(kinds.values())
    cfg, shape = get_config("smollm-135m"), INPUT_SHAPES[shape_name]
    data = 32 if multi else 16
    if shape.kind != "decode":  # K11 / K11b at this rank's batch and every head
        kshape = (shape.global_batch // data, cfg.n_heads, cfg.n_kv_heads, shape.seq_len,
                  cfg.hd, cfg.hd)
        calls = (2 * LAYERS, LAYERS) if shape.kind == "train" else (LAYERS, 0)
        lse = shape.kind == "train"
        fwd = fa.forward_cost(kshape, cfg.dtype, True, 0, return_lse=lse)
        assert count.kernels["flash_attention"] == dict(calls=calls[0], flops=calls[0] * fwd[0],
                                                        bytes=calls[0] * fwd[1])
        assert count.kernels["flash_attention_bwd"]["calls"] == calls[1]
    flops = rec["roofline"]["flops_per_chip"]
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_global"] / (flops * rec["n_chips"]), rel=1e-12)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_train_step_on_the_single_mesh(arch):
    depth = roofline_sweep.probe_depths(arch)[0]
    with OnlyMeta():
        rec, count = dryrun.lower_combo(arch, "train_4k", "single", depth=depth)
    kinds = rec["roofline"]["coll_by_kind"]
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert kinds["all_reduce"] > 0 and kinds["all_gather"] > 0 and kinds["reduce_scatter"] == 0
    assert rec["roofline"]["flops_per_chip"] > 0 and 0 < rec["useful_flops_ratio"]
    # the reference's §Perf switches: seq_parallel's reduce-scatters
    opt, _ = dryrun.lower_combo(arch, "train_4k", "single", depth=depth, opt=True)
    assert opt["roofline"]["coll_by_kind"]["reduce_scatter"] > 0


def test_functional_collectives_are_counted_per_card():
    with fake_production_mesh() as mesh:
        group = mesh.get_group("model")
        x = torch.empty((8, 32), device="meta")

        def step(x):
            y = funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
            z = funcol.wait_tensor(funcol.all_gather_tensor(y, 0, group))
            return funcol.wait_tensor(funcol.reduce_scatter_tensor(z, "sum", 0, group))

        out, count = roofline.count_step(step, x)
    assert tuple(out.shape) == (8, 32)
    assert count.coll_by_kind == {"all_reduce": 8 * 32 * 4, "all_gather": 16 * 8 * 32 * 4,
                                  "reduce_scatter": 8 * 32 * 4, "all_to_all": 0}


def test_cli_single_and_multi_records(tmp_path):
    recs = dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "both",
                        "--out", str(tmp_path)])
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for name, chips in (("16x16", 256), ("2x16x16", 512)):
        rec = json.loads((tmp_path / f"smollm-135m_decode_32k_{name}.json").read_text())
        assert rec["n_chips"] == chips and rec["kind"] == "decode"
        assert rec["roofline"]["coll_by_kind"]["all_reduce"] > 0


def test_sweep_records_the_reference_mesh():
    rec = roofline_sweep.sweep_combo("smollm-135m", "decode_32k")
    assert rec["mesh"] == "16x16"
    one = dryrun.lower_combo("smollm-135m", "decode_32k", "single", depth=2)[0]
    assert rec["probe_records"][0]["roofline"] == one["roofline"]
    assert rec["full_depth"] == get_config("smollm-135m").n_layers
