"""Guards of the PyTorch port: what it imports, where it runs, what it leaves out."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import rf_tca as trf  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_has_no_fallback_from_kernel_to_plain():
    """No ``try`` in the kernel modules: a CUDA launch succeeds or raises."""
    for f in sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py")):
        tries = [n for n in ast.walk(ast.parse(f.read_text())) if isinstance(n, ast.Try)]
        assert not tries, f"{f.name} has a try block"


def _data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(6, 40)).astype(np.float32), rng.normal(size=(6, 30)).astype(
        np.float32
    )


def test_fit_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    xs, xt = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        trf.rf_tca_fit(xs, xt, n_features=16, m=2, w_rf="fused:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_omega_draws_without_device_raise_without_card():
    """The seed-defined draws are entry points too: no device means the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    for draw in (lambda: prng.fused_omega(0, 8, 4),
                 lambda: prng.fused_omega_block(0, 8, 4),
                 lambda: prng.threefry_bits(0, 8, 4),
                 lambda: prng.fused_omega_block_plain(0, 8, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            draw()
    assert prng.fused_omega(0, 8, 4, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(w_rf=None),
    dict(w_rf=None, mode="dense"),
    dict(w_rf="fused:1", solver="lobpcg"),
    dict(w_rf=None, mode="dense", solver="cholesky"),
])
def test_paths_outside_the_slice_raise(kw):
    """The fit paths the first slice left out (each raised NotImplementedError)
    now run: a finite (2N, m) aligner, Omega kept exactly when w_rf is None."""
    xs, xt = _data()
    state = trf.rf_tca_fit(xs, xt, n_features=16, m=2, device="cpu", **kw)
    assert tuple(state.w_rf.shape) == (32, 2)
    assert bool(torch.isfinite(state.w_rf).all() and torch.isfinite(state.eigvals).all())
    assert (state.omega is None) == (kw["w_rf"] is not None)
    if state.omega is not None:
        assert tuple(state.omega.shape) == (16, 6)


def test_solvers_outside_the_slice_raise():
    """The solvers the first slice left out run; an unknown one still raises."""
    g = torch.diag(torch.arange(1.0, 9.0))
    u = torch.ones(8) * 1e-3
    w_e, v_e = trf.solve_w_rf_gram(g, u, 1e-2, 1, solver="eigh")
    w_l, v_l = trf.solve_w_rf_gram(g, u, 1e-2, 1, solver="lobpcg")
    np.testing.assert_allclose(v_l.numpy(), v_e.numpy(), rtol=1e-4)
    sig = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 20)).astype(np.float32))
    ell = torch.linspace(-1.0, 1.0, 20)
    _, v_c = trf.solve_w_rf(sig, ell, 1e-2, 2, solver="cholesky")
    _, v_s = trf.solve_w_rf(sig, ell, 1e-2, 2, solver="eigh")
    np.testing.assert_allclose(v_c.numpy(), v_s.numpy(), rtol=1e-4)
    with pytest.raises(ValueError):
        trf.solve_w_rf_gram(g, u, 1e-2, 2, solver="qr")


def test_no_path_is_left_unported():
    """No ``NotImplementedError`` is left in the RF-TCA entry points."""
    src = (ROOT / "src" / "repro_torch" / "core" / "rf_tca.py").read_text()
    assert "NotImplementedError" not in src


@pytest.mark.parametrize("kw,err", [
    (dict(w_rf="fused:1", mode="tiled"), ValueError),
    (dict(w_rf="fused:1", solver="cholesky"), ValueError),
    (dict(w_rf="seed:1"), ValueError),
    (dict(w_rf=None, ensemble=2), ValueError),
])
def test_fit_argument_errors_match_reference(kw, err):
    xs, xt = _data()
    with pytest.raises(err):
        trf.rf_tca_fit(xs, xt, n_features=16, m=2, device="cpu", **kw)
    with pytest.raises(ValueError, match="fused"):
        trf.rf_tca_fit_with_stats(xs, xt, n_features=16, m=2, device="cpu")


SLICE3_MODULES = (
    "utils/tree.py", "optim/optimizers.py", "obs/registry.py", "obs/records.py",
    "robust/rules.py", "federated/network.py", "federated/model.py",
    "federated/aggregation.py", "kernels/quantize.py", "comm/codecs.py", "comm/wire.py",
    "comm/transport.py", "comm/netsim.py", "comm/autocodec.py", "checkpoint/ckpt.py",
    "federated/engine.py", "federated/protocol.py",
    # the fleet and robust slice
    "fleet/__init__.py", "fleet/topology.py", "fleet/hierarchy.py", "fleet/sharding.py",
    "robust/__init__.py", "robust/faults.py", "kernels/segment_reduce.py",
)


def test_training_slice_modules_are_in_the_import_guard():
    """The FedRF-TCA slice's modules exist and fall under the jax/repro guard
    of ``test_port_imports_neither_jax_nor_reference`` (which scans them all)."""
    files = set(_port_files())
    for rel in SLICE3_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path in files, rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}, rel
    for name in ("quantize.cu", "segment_reduce.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / name).exists()


def _fed():
    from repro_torch.data import make_domains
    from repro_torch.federated import ClientConfig

    doms = make_domains(3, 40, dim=6, n_classes=2, seed=0)
    cfg = ClientConfig(input_dim=6, n_classes=2, n_rff=8, m=2, extractor_widths=(4,))
    return doms[:2], doms[2], cfg


def test_trainer_without_device_raises_without_card():
    from repro_torch.federated import FedRFTCATrainer, ProtocolConfig, init_params, make_omega

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    sources, target, cfg = _fed()
    for call in (lambda: FedRFTCATrainer(sources, target, cfg, ProtocolConfig(warmup_rounds=0)),
                 lambda: make_omega(cfg), lambda: init_params(cfg, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    tr = FedRFTCATrainer(sources, target, cfg, ProtocolConfig(warmup_rounds=0, n_rounds=1),
                         device="cpu")
    assert tr.omega.device.type == "cpu" and tr._w_init.device.type == "cpu"


def _fault_config():
    from repro_torch.robust import FaultConfig

    return FaultConfig(corrupt_moments=0.5, corrupt_w_rf=0.5, corruption="nan")


def _two_edges():
    from repro_torch.fleet import Topology

    return Topology.of_groups([[0], [1]])


@pytest.mark.parametrize("field,value,step", [
    ("topology", _two_edges, None),
    ("client_chunk", lambda: 1, None),
    ("faults", _fault_config, None),
    ("probe", lambda: True, None),
    ("rule", lambda: "trimmed_mean:0.2", None),
    ("rule", lambda: "geomedian", None),
])
def test_paths_left_out_of_the_training_slice_raise(field, value, step):
    """The training slice left fleet, robust rules, faults and the probes
    out; they now build and take a round on the CPU."""
    from repro_torch.federated import FedRFTCATrainer, ProtocolConfig

    sources, target, cfg = _fed()
    proto = ProtocolConfig(warmup_rounds=0, n_rounds=2, t_c=2, batch_size=16,
                           **{field: value()})
    if step is not None:
        with pytest.raises(NotImplementedError, match=step):
            FedRFTCATrainer(sources, target, cfg, proto, device="cpu")
        return
    tr = FedRFTCATrainer(sources, target, cfg, proto, device="cpu")
    tr.train()
    assert tr.comm.rounds == 2 and 0.0 <= tr.evaluate() <= 1.0
    if field == "rule":
        assert not tr.rule.is_mean and all(bool(torch.isfinite(x).all())
                                            for x in tree_leaves(tr.tgt_params))
    if field == "probe":
        assert set(tr.last_probes) == {"moment_mass", "attribution_moments", "attribution_w_rf",
                                       "update_norm", "tgt_update_norm"}


def test_engine_seams_left_out_raise():
    """Of the engine seams the training slice left out, topology,
    client_chunk, faults and the probes now build, and the async flush
    (step 8) runs under ``fedsim.AsyncScheduler``."""
    from repro_torch.federated import (
        BatchedRoundEngine, ClientConfig, FedRFTCATrainer, ProtocolConfig, aggregation,
    )
    from repro_torch.fedsim import AsyncConfig, AsyncScheduler
    from repro_torch.kernels import segment_reduce
    from repro_torch.optim import adam
    from repro_torch.robust import build_fault_plan, get_rule

    cfg = ClientConfig(input_dim=6, n_classes=2, n_rff=8, m=2, extractor_widths=(4,))
    omega = torch.zeros((8, 4))
    for kw in (dict(topology=_two_edges()), dict(client_chunk=4),
               dict(faults=build_fault_plan(_fault_config(), 2))):
        eng = BatchedRoundEngine(cfg, adam(1e-2), omega, **kw)
        assert getattr(eng, next(iter(kw))) is kw[next(iter(kw))]
    sources, target, fed_cfg = _fed()
    probed = FedRFTCATrainer(sources, target, fed_cfg,
                             ProtocolConfig(warmup_rounds=0, t_c=2, batch_size=16, probe=True),
                             device="cpu")
    assert probed._engine.probe
    AsyncScheduler(probed, AsyncConfig(buffer_size=1)).run(1)
    assert set(probed.last_probes) == {"moment_mass", "attribution_moments", "attribution_w_rf",
                                       "update_norm", "tgt_update_norm"}
    tr = FedRFTCATrainer(sources, target, fed_cfg, ProtocolConfig(warmup_rounds=0, t_c=2,
                                                                  batch_size=16), device="cpu")
    hist = AsyncScheduler(tr, AsyncConfig(buffer_size=1)).run(2)
    assert [h["flush"] for h in hist] == [1, 2] and tr.model_version == 2
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(tr.tgt_params))
    # the K9 seam: the plain version on CPU tensors, no kernel launch
    launches = segment_reduce.LAUNCHES["segment_reduce"]
    out = aggregation.edge_weighted_sums(torch.ones((5, 4)), torch.tensor([0, 1, 2, 0, 1]),
                                         torch.ones(5), 3)
    assert out.tolist() == [[2.0] * 4, [2.0] * 4, [1.0] * 4]
    assert segment_reduce.LAUNCHES["segment_reduce"] == launches
    assert get_rule("mean").is_mean and not get_rule("geomedian").is_mean
    with pytest.raises(ValueError):
        get_rule("median")


SLICE5_MODULES = (
    "configs/__init__.py", "configs/base.py", "configs/smollm_135m.py",
    "configs/internlm2_1p8b.py", "models/__init__.py", "models/param.py", "models/layers.py",
    "models/attention.py", "models/blocks.py", "models/fda_head.py", "models/model.py",
    "kernels/flash_attention.py", "launch/__init__.py", "launch/serve.py",
)


def test_lm_slice_modules_are_in_the_import_guard():
    """The serve slice's modules exist and fall under the jax/repro guard;
    K11's kernel module falls under the no-``try`` guard (it scans every
    module of ``kernels/``) and its CUDA source is built with the others."""
    from repro_torch.kernels import _build

    files = set(_port_files())
    for rel in SLICE5_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path in files, rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}, rel
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu").exists()
    assert "flash_attention" in _build.SOURCES


def test_lm_without_device_raises_without_card():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    model = LM(get_config("smollm-135m").reduced())
    for call in (model.init, lambda: model.init_cache(1, 4),
                 lambda: serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                                     "--gen", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert model.init(0, device="cpu")["ln_f"]["scale"].device.type == "cpu"


@pytest.mark.parametrize("arch,step", [
    ("mamba2-2.7b", "step 13e"), ("zamba2-7b", "step 13f"),
    ("llama-3.2-vision-90b", "step 13g"), ("musicgen-large", "step 13h"),
])
def test_lm_families_outside_the_slice_raise(arch, step):
    """The four families that raised, naming their steps, until those steps
    were ported (SSM, hybrid, VLM, audio) now build an ``LM``, at full size
    and reduced, whose declarations have the reference's keys and shapes."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import LM as JLM
    from repro.models import ShardRules
    from repro.models.param import is_decl
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    def port_shapes(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(port_shapes(v, (*prefix, k)) if isinstance(v, dict)
                       else {(*prefix, k): tuple(v.shape)})
        return out

    for cfg, ref in ((get_config(arch), jget_config(arch)),
                     (get_config(arch).reduced(), jget_config(arch).reduced())):
        ref_shapes = {tuple(p.key for p in kp): tuple(d.shape) for kp, d in
                      jax.tree_util.tree_flatten_with_path(
                          JLM(ref, ShardRules(model_size=1)).decls(), is_leaf=is_decl)[0]}
        assert port_shapes(LM(cfg).decls()) == ref_shapes, (arch, step)


def test_lm_loss_and_other_blocks_raise():
    """LM.loss runs since step 13b (its parity is tests/test_torch_train.py's);
    MoE and MLA blocks run since steps 13c and 13d (tests/test_torch_moe.py),
    the SSM, hybrid, cross-attention and audio families since 13e-13h
    (tests/test_torch_ssm.py, tests/test_torch_vlm_audio.py), and the
    expert-parallel MoE since 13i (tests/test_torch_moe_ep.py)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import LM, moe

    cfg = get_config("smollm-135m").reduced()
    model = LM(cfg)
    params = model.init(0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    total, parts = model.loss(params, {"tokens": toks, "labels": toks}, 2)
    assert set(parts) == {"ce", "aux", "mmd"} and bool(torch.isfinite(total))
    assert callable(moe.moe_forward_ep)
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert LM(get_config(arch)).param_count() > 0


SLICE14_MODULES = ("models/moe.py", "federated/distributed.py")


def test_moe_slice_modules_are_in_the_import_guard():
    """The MoE slice's modules exist and fall under the jax/repro guard; no
    ``NotImplementedError`` is left in the models for MoE or MLA (only the
    expert-parallel MoE raises, naming the mesh's step 13i)."""
    files = set(_port_files())
    for rel in SLICE14_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path in files, rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}, rel
    for f in sorted((ROOT / "src" / "repro_torch" / "models").glob("*.py")):
        for line in f.read_text().splitlines():
            if "NotImplementedError" in line or "ROADMAP queue 1, step" in line:
                assert not any(w in line for w in ("MoE blocks", "MLA", "13c", "13d")), line


SLICE15_MODULES = ("models/ssm.py",)


def test_last_families_slice_modules_are_in_the_import_guard():
    """The SSM module exists and falls under the jax/repro guard; under
    ``models/`` no ``NotImplementedError`` is left (the expert-parallel MoE's,
    naming step 13i, went with step 13i)."""
    files = set(_port_files())
    for rel in SLICE15_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path in files, rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}, rel
    raising = []
    for f in sorted((ROOT / "src" / "repro_torch" / "models").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Raise) and "NotImplementedError" in ast.unparse(node):
                raising.append((f.name, ast.unparse(node)))
    assert raising == [], raising


SLICE16_MODULES = ("launch/roofline.py", "launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
                   "launch/roofline_sweep.py")
# the abstract base methods (ROADMAP): a subclass implements each
ABSTRACT_RAISES = {("robust/rules.py", 77), ("comm/codecs.py", 102), ("comm/codecs.py", 105),
                   ("comm/codecs.py", 108), ("comm/transport.py", 186), ("comm/netsim.py", 50)}


def test_every_reference_module_has_a_counterpart_and_nothing_is_left_raising():
    """Every module of the reference's ``launch/`` and ``models/`` has a file of
    the same name under ``src/repro_torch/``, the launch tools and the examples
    fall under the jax/repro guard, and no function of the port raises
    ``NotImplementedError`` but the abstract base methods."""
    files = set(_port_files())
    for pkg in ("launch", "models"):
        for ref in sorted((ROOT / "src" / "repro" / pkg).glob("*.py")):
            assert ROOT / "src" / "repro_torch" / pkg / ref.name in files, f"{pkg}/{ref.name}"
    for rel in SLICE16_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}, rel
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_federated_adaptation.py",
                                          "torch_quickstart.py", "torch_serve_batch.py",
                                          "torch_train_lm.py"]
    assert all(p in files for p in examples)
    raising = set()
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Raise) and "NotImplementedError" in ast.unparse(node):
                raising.add((str(f.relative_to(ROOT / "src" / "repro_torch")), node.lineno))
    assert raising == ABSTRACT_RAISES, sorted(raising ^ ABSTRACT_RAISES)
