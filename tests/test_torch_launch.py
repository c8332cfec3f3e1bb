"""Port parity: the launch tools (repro_torch.launch.roofline, mesh, specs and
dryrun's parameter counts) against repro's on the CPU.

Exact equality throughout: the roofline's terms at the port's H100 constants
and ``as_dict``'s keys (tests/test_dryrun.py:28, 36); ``model_flops``;
``active_params``, ``param_count``, ``adjusted_config`` and
``probe_depths`` for every ``ARCH_IDS`` x ``INPUT_SHAPES`` pair;
``input_specs``' shapes and dtypes; ``input_pspecs`` and ``cache_pspecs``
leaf by leaf against the reference's ``PartitionSpec``s as tuples, under
one-pod and two-pod batch axes (tests/test_launch.py:11-53, the long_500k,
decode_32k and MLA-cache cases included).  The meshes: ``make_host_mesh`` on
a one-rank gloo group and with none, ``make_production_mesh`` raising with
the rank count, and ``roofline.collective_bytes`` counting one all-reduce.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import roofline_sweep as jsweep  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ShardRules as JRules  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline, roofline_sweep, specs  # noqa: E402
from repro_torch.models import LM, ShardRules  # noqa: E402

PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
BATCH_AXES = (("data",), ("pod", "data"))
_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_registries_match_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in J_SHAPES.items()}


def test_roofline_terms_at_the_h100_constants():
    r = roofline.Roofline(989e12, 3.35e12, 450e9, {})
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    assert r.dominant in ("compute", "memory", "collective")
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == (989e12, 3.35e12,
                                                                          450e9)
    assert roofline.Roofline(2 * 989e12, 3.35e12, 0.0, {}).dominant == "compute"
    assert roofline.Roofline(0.0, 1.0, 0.0, {}).dominant == "memory"
    ref = jroof.Roofline(1.0, 2.0, 3.0, {"x": 1}).as_dict()
    assert list(roofline.Roofline(1.0, 2.0, 3.0, {"x": 1}).as_dict()) == list(ref)


def test_model_flops_matches_reference():
    assert roofline.model_flops(100, 10, "train") == 6000
    assert roofline.model_flops(100, 10, "decode") == 2000
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(12345, 678, kind) == jroof.model_flops(12345, 678, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_configs_and_probe_depths_match_reference(arch):
    assert roofline_sweep.probe_depths(arch) == jsweep.probe_depths(arch)
    for name in INPUT_SHAPES:
        cfg = dryrun.adjusted_config(get_config(arch), INPUT_SHAPES[name])
        jcfg = jdryrun.adjusted_config(jget_config(arch), J_SHAPES[name])
        assert cfg.attn_window == jcfg.attn_window and cfg.n_layers == jcfg.n_layers
        model, jmodel = LM(cfg), JLM(jcfg, JRules(model_size=1))
        assert model.param_count() == jmodel.param_count()
        assert dryrun.active_params(model) == jdryrun.active_params(jmodel)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_specs_and_placements_match_reference(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = dryrun.adjusted_config(get_config(arch), shape)
    jcfg = jdryrun.adjusted_config(jget_config(arch), J_SHAPES[shape_name])
    got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, J_SHAPES[shape_name])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape) and t.dtype == _DTYPES[want[k].dtype], k
    for axes in BATCH_AXES:
        rules, jrules = ShardRules(model_size=16, batch_axes=axes), JRules(model_size=16,
                                                                          batch_axes=axes)
        assert specs.rules_data_size(rules) == jspecs.rules_data_size(jrules)
        assert specs.input_pspecs(cfg, shape, rules) == _tuples(
            jspecs.input_pspecs(jcfg, J_SHAPES[shape_name], jrules))
        if shape.kind == "decode":
            assert specs.cache_pspecs(LM(cfg, rules), shape, rules) == _tuples(
                jspecs.cache_pspecs(JLM(jcfg, jrules), J_SHAPES[shape_name], jrules))


def test_long500k_batch_not_sharded_but_cache_seq_is():
    """tests/test_launch.py:38-49."""
    rules = ShardRules(model_size=16, batch_axes=("data",))
    cfg = dataclasses.replace(get_config("command-r-plus-104b"), attn_window=4096)
    k_spec = specs.cache_pspecs(LM(cfg, rules), INPUT_SHAPES["long_500k"], rules)["layers"]["k"]
    assert k_spec[1] is None  # batch = 1 can't shard
    assert k_spec[2] == "data"  # the cache's sequence context-parallel over data


def test_decode32k_batch_sharded_and_mla_cache_compressed():
    """tests/test_launch.py:52-57 and :70-79."""
    rules = ShardRules(model_size=16, batch_axes=("data",))
    cps = specs.cache_pspecs(LM(get_config("internlm2-1.8b"), rules),
                             INPUT_SHAPES["decode_32k"], rules)
    assert cps["layers"]["k"][1] == "data" and cps["layers"]["k"][2] is None
    cfg = get_config("deepseek-v2-lite-16b")
    shapes = LM(cfg).cache_shapes(1, 1000)
    per_tok_mla = shapes["layers"]["c"][-1] + shapes["layers"]["kr"][-1]
    assert per_tok_mla == cfg.kv_lora_rank + cfg.rope_head_dim
    assert per_tok_mla < cfg.n_kv_heads * cfg.hd * 2 / 7
    mla = specs.cache_pspecs(LM(cfg, rules), INPUT_SHAPES["decode_32k"], rules)["layers"]
    assert mla["c"] == (None, "data", None, None) == mla["kr"]


def test_abstract_trees_are_meta_and_match_init_shapes():
    cfg = get_config("smollm-135m").reduced()
    model = LM(cfg)
    params, shapes = model.abstract(), model.init(0, device="cpu")
    flat = [(t.device.type, tuple(t.shape), t.dtype) for t in _leaves(params)]
    assert flat == [("meta", tuple(t.shape), t.dtype) for t in _leaves(shapes)]
    cache = model.abstract_cache(2, 16)
    assert [(tuple(t.shape), t.dtype) for t in _leaves(cache)] == [
        (tuple(t.shape), t.dtype) for t in _leaves(model.init_cache(2, 16, device="cpu"))]
    assert all(t.device.type == "meta" for t in _leaves(cache))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_meshes_without_a_group_and_production_mesh_raising():
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    m = mesh.make_host_mesh(model=4, device="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert mesh.data_axis_size(m) == 1 and mesh.axis_size(m, "model") == 1
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks.*have 1"):
            mesh.make_production_mesh(multi_pod=multi, device="cpu")


def test_host_mesh_on_a_one_rank_gloo_group_and_collective_bytes(tmp_path):
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        m = mesh.make_host_mesh(model=2)
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
        assert m.device_type == "cpu" and mesh.data_axis_size(m) == 1
        with pytest.raises(RuntimeError, match="need 256 ranks for the production mesh, have 1"):
            mesh.make_production_mesh()

        def step(x):
            dist.all_reduce(x, group=m.get_group("model"))
            return x @ x.T

        x = torch.ones((6, 4))
        kinds = roofline.collective_bytes(step, x)
        assert kinds == {"all_reduce": 96, "all_gather": 0, "reduce_scatter": 0,
                         "all_to_all": 0}
        r = roofline.from_step(step, x)
        assert r.coll_bytes_per_chip == 96 and r.flops_per_chip == 2 * 6 * 6 * 4
        assert r.as_dict()["coll_by_kind"] == kinds
    finally:
        dist.destroy_process_group()


def test_step_counter_bytes_and_views():
    """Every input read once and every output written once; views and
    ``empty`` move nothing; products by flop_counter's formulas."""
    a, b = torch.ones((8, 16)), torch.ones((16, 4))

    def step(a, b):
        c = (a @ b).T  # mm: reads 8x16 + 16x4, writes 8x4; the transpose is a view
        d = torch.empty((3, 3))
        return c + 1.0, d  # add: reads 4x8, writes 4x8

    out, count = roofline.count_step(step, a, b)
    assert count.flops == 2 * 8 * 16 * 4
    assert count.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * (32 + 32)
    assert count.peak_bytes >= 4 * (32 + 9 + 32) - 4 * 32 and count.alias_bytes == 0
    assert np.isfinite(count.total_flops)
