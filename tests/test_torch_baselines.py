"""Port parity: the DA baselines (repro_torch.baselines), vertical FL
(repro_torch.federated.vertical) and the package surfaces (repro_torch.core,
repro_torch.utils) against repro on the CPU.

The suite is tests/test_baselines.py's: ``make_domains(3, 250, shift=1.0,
seed=5)``, two sources and a target.  Each trainer starts from the
reference's initial weights (its ``jax.random`` draws, made here as it
makes them) and is held to the reference's result: accuracies equal, logits
within 1e-4 of max(1, max|logit|).  Features: TCA and R-TCA within 1e-4 of
the reference's (fp32 eigenvectors, signs canonical on both sides),
RF-TCA's seed-fused ones likewise; CORAL's and JDA's (float64 numpy on the
host) within 1e-6 relative; the pipelines' accuracies from the same
features equal.

The MLP is held for fit_mlp's 300 steps on the raw features and for 50 on
standardised TCA and CORAL features: over longer runs on those, a ReLU
pattern that one package's rounding flips and the other's does not moves
the logits by up to ~4e-4 (150 steps, measured), far more than a 1e-7
nudge of either start does, so the comparison would test the inputs'
conditioning rather than the loop.  JDA's Cholesky whitening of gamma I +
K M K at gamma = 1e-3 from an fp32 kernel amplifies fp32 rounding in both
packages: its features are held to 1e-6 relative plus four times what a
1e-7 relative nudge of the data moves the port's own features.

RF-TCA with its own Omega is held as tests/test_baselines.py holds the
reference: within 0.2 of R-TCA.  Vertical RFF within 1e-5
(tests/test_vertical.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.baselines.da_methods as jda  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.utils as jutils  # noqa: E402
from repro.baselines import classifiers as jcls  # noqa: E402
from repro.core.rff import draw_omega as jdraw_omega  # noqa: E402
from repro.core.rff import rff_features as jrff_features  # noqa: E402
from repro.federated import model as jfm  # noqa: E402
from repro.federated import vertical as jvert  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.utils as tutils  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.baselines import classifiers as tcls  # noqa: E402
from repro_torch.baselines import da_methods as tda  # noqa: E402
from repro_torch.core.kernels_math import ell_vector  # noqa: E402
from repro_torch.core.rf_tca import solve_w_rf  # noqa: E402
from repro_torch.core.rff import draw_omega, rff_features  # noqa: E402
from repro_torch.data import Domain, make_domains  # noqa: E402
from repro_torch.federated import ClientConfig, logits_of  # noqa: E402
from repro_torch.federated import vertical as tvert  # noqa: E402

CPU = "cpu"


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


@pytest.fixture(scope="module")
def suite():
    doms = make_domains(3, 250, shift=1.0, seed=5)
    return doms[:2], doms[2]


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))) / max(1.0, float(np.max(np.abs(b))))


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _ref_mlp_init(widths, seed) -> list[dict]:
    """repro.baselines.classifiers.fit_mlp's initial weights."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(widths))
    return [{"w": np.asarray(jax.random.normal(keys[i], (din, dout)) * jnp.sqrt(2.0 / din)),
             "b": np.zeros((dout,), np.float32)}
            for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:]))]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _nudged(x: np.ndarray, seed: int = 1) -> np.ndarray:
    """x times (1 + 1e-7 noise): a start one fp32 rounding away."""
    rng = np.random.default_rng(seed)
    return (x * (1 + 1e-7 * rng.normal(size=x.shape))).astype(x.dtype)


def _mlp_against_reference(feats_s, y_s, feats_t, y_t, n_classes, steps=300):
    """fit_mlp in both packages from the reference's weights: equal
    accuracies, logits within 1e-4 of max(1, max|logit|)."""
    predict = jcls.fit_mlp(feats_s, y_s, n_classes, steps=steps)
    ref = _closure(predict)
    init = _ref_mlp_init((feats_s.shape[1], 100, 100, n_classes), 0)
    params = tcls.train_mlp([{k: _t(v) for k, v in layer.items()} for layer in init],
                            _t(feats_s), torch.tensor(y_s, dtype=torch.int64), n_classes,
                            steps=steps)
    ours = tcls.mlp_apply(params, _t(feats_t)).detach().numpy()
    theirs = np.asarray(ref["apply"](ref["params"], jnp.asarray(feats_t, jnp.float32)))
    assert _rel(ours, theirs) <= 1e-4
    acc = float(np.mean(np.argmax(ours, -1) == y_t))
    assert acc == jcls.score(predict, feats_t, y_t)
    return acc


def test_concat_unit_and_standardize_match_reference(suite):
    s, t = suite
    a, b = tda._concat(s), jda._concat(s)
    assert a.name == b.name
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(tda._unit(t).x, jda._unit(t).x)


def test_source_only_mlp_matches_reference(suite):
    s, t = suite
    src = tda._concat(s)
    _mlp_against_reference(src.x.T, src.y, t.x.T, t.y, 5)


def test_knn_and_logreg_run(suite):
    s, t = suite
    src = tda._concat(s)
    assert tda.source_only(s, t, classifier="knn", device=CPU) == jda.source_only(
        s, t, classifier="knn")
    assert 0.0 <= tcls.score(tcls.fit_logreg(src.x.T, src.y, 5, steps=50, device=CPU),
                             t.x.T, t.y) <= 1.0


def _captured_eval(monkeypatch, module):
    """Record what a pipeline hands its module's ``_transductive_eval``."""
    seen = []
    real = module._transductive_eval

    def capture(feats_s, y_s, feats_t, y_t, *args, **kw):
        seen.append((np.asarray(feats_s), np.asarray(y_s), np.asarray(feats_t),
                     np.asarray(y_t)))
        return real(feats_s, y_s, feats_t, y_t, *args, **kw)

    monkeypatch.setattr(module, "_transductive_eval", capture)
    return seen


@pytest.mark.parametrize("variant", ["vanilla", "r"])
def test_tca_features_and_accuracy_match_reference(suite, monkeypatch, variant):
    s, t = suite
    seen = _captured_eval(monkeypatch, jda)
    jda.tca_baseline(s, t, gamma=1e-3, variant=variant, m=16)
    fs, ys, ft, yt = seen[0]
    ref = tda.canonical_signs(np.concatenate([fs, ft]).T)
    ours, _, _ = tda.tca_features(s, t, m=16, gamma=1e-3, variant=variant, device=CPU)
    assert _rel(ours, ref) <= 1e-4
    n_s = fs.shape[0]
    a, b = tda.standardize(ref[:, :n_s].T, ref[:, n_s:].T)
    _mlp_against_reference(a, ys, b, yt, 5, steps=50)
    if variant == "vanilla":  # tests/test_baselines.py: better than 5-class chance
        assert tda.tca_baseline(s, t, gamma=1e-3, m=16, device=CPU) > 1.0 / 5 + 0.05


def test_rf_tca_baseline(suite, monkeypatch):
    s, t = suite
    # seed-fused: both packages draw Omega from the same threefry stream
    seen = _captured_eval(monkeypatch, jda)
    jda.rf_tca_baseline(s, t, gamma=1e-3, n_features=256, m=8, w_rf="fused:3")
    fs, _, ft, _ = seen[0]
    ref = tda.canonical_signs(np.concatenate([fs, ft]).T)
    mine = _captured_eval(monkeypatch, tda)
    tda.rf_tca_baseline(s, t, gamma=1e-3, n_features=256, m=8, w_rf="fused:3", device=CPU)
    ours = np.concatenate([mine[0][0], mine[0][2]]).T
    assert _rel(ours, ref) <= 1e-4
    # its own Omega: as tests/test_baselines.py::test_rf_tca_close_to_r_tca
    a_r = tda.tca_baseline(s, t, gamma=1e-3, variant="r", m=16, device=CPU)
    a_rf = tda.rf_tca_baseline(s, t, gamma=1e-3, n_features=1024, m=16, device=CPU)
    assert abs(a_r - a_rf) < 0.2, (a_r, a_rf)


def test_coral_matches_reference(suite, monkeypatch):
    s, t = suite
    seen = _captured_eval(monkeypatch, jda)
    jda.coral_baseline(s, t)
    xs_ref, ys, xt, yt = seen[0]
    xs, _ = tda.coral_features(s, t)
    assert float(np.max(np.abs(xs - xs_ref))) <= 1e-6 * float(np.max(np.abs(xs_ref)))
    a, b = tda.standardize(xs_ref, xt)
    _mlp_against_reference(a, ys, b, yt, 5, steps=50)


def _captured_knn(monkeypatch, module):
    seen = []
    real = module.knn_1

    def capture(train_feats, train_labels, **kw):
        seen.append(np.asarray(train_feats))
        return real(train_feats, train_labels, **kw)

    monkeypatch.setattr(module, "knn_1", capture)
    return seen


def test_jda_matches_reference(suite, monkeypatch):
    s, t = suite
    ref_feats = _captured_knn(monkeypatch, jda)
    ref = jda.jda_baseline(s, t, gamma=1e-3, iters=2)
    our_feats = _captured_knn(monkeypatch, tda)
    ours = tda.jda_baseline(s, t, gamma=1e-3, iters=2, device=CPU)
    assert ours == ref
    tda.jda_baseline([Domain(d.name, _nudged(d.x, i), d.y) for i, d in enumerate(s)],
                     Domain(t.name, _nudged(t.x, 9), t.y), gamma=1e-3, iters=2, device=CPU)
    assert len(ref_feats) == 2 and len(our_feats) == 4  # then the nudged run's
    for a, b, c in zip(our_feats[:2], ref_feats, our_feats[2:]):
        scale = float(np.max(np.abs(b)))
        moved = float(np.max(np.abs(c - a))) / scale
        assert float(np.max(np.abs(a - b))) / scale <= 1e-6 + 4 * moved, moved


def test_dann_matches_reference(suite, monkeypatch):
    s, t = suite
    src = tda._concat(s)
    logits = []
    real = jda.jnp

    class Spy:  # the reference's final logits pass through jnp.argmax
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def argmax(x, *a, **kw):
            logits.append(np.asarray(x))
            return real.argmax(x, *a, **kw)

    monkeypatch.setattr(jda, "jnp", Spy())
    ref = jda.dann_mmd_baseline(s, t, steps=150)
    monkeypatch.undo()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    p = src.x.shape[0]
    init = {"w1": jax.random.normal(k1, (p, 64)) * jnp.sqrt(2.0 / p), "b1": np.zeros(64),
            "w2": jax.random.normal(k2, (64, 5)) / jnp.sqrt(64), "b2": np.zeros(5)}
    xs, xt = _t(src.x.T), _t(t.x.T)
    params = tda.dann_train({k: _t(v) for k, v in init.items()}, xs,
                            torch.tensor(src.y, dtype=torch.int64), xt, 5, steps=150)
    ours = (tda.dann_hidden(params, xt) @ params["w2"] + params["b2"]).detach().numpy()
    assert _rel(ours, logits[-1]) <= 1e-4
    # the reference's accuracies are fp32 means of 250 hits
    assert float(np.mean(np.argmax(ours, -1) == t.y)) == pytest.approx(ref, abs=1e-6)
    assert 0.0 <= tda.dann_mmd_baseline(s, t, steps=20, device=CPU) <= 1.0


def test_fedavg_matches_reference(suite, monkeypatch):
    s, t = suite
    p = s[0].x.shape[0]
    seen = []
    real = jda.accuracy

    def capture(params, omega, x, y):
        seen.append((params, omega))
        return real(params, omega, x, y)

    monkeypatch.setattr(jda, "accuracy", capture)
    jcfg = jfm.ClientConfig(input_dim=p, n_classes=5)
    ref = jda.fedavg_baseline(s, t, jcfg, rounds=20)
    keys = jax.random.split(jax.random.PRNGKey(0), len(s))
    init = [convert.params_from_reference(jax.tree_util.tree_map(
        np.asarray, jfm.init_params(jcfg, keys[i])), device=CPU) for i in range(len(s))]
    omega = _t(np.asarray(seen[0][1]))
    cfg = ClientConfig(input_dim=p, n_classes=5)
    params = tda.fedavg_train(init, s, omega, cfg, rounds=20)
    ref_params = jax.tree_util.tree_map(np.asarray, seen[0][0])
    ours = logits_of(params[0], omega, _t(t.x)).detach().numpy()
    theirs = np.asarray(jfm.logits_of(ref_params, jnp.asarray(seen[0][1]), jnp.asarray(t.x)))
    assert _rel(ours, theirs) <= 1e-4
    # the reference's accuracies are fp32 means of 250 hits
    assert float(np.mean(np.argmax(ours, -1) == t.y)) == pytest.approx(ref, abs=1e-6)
    acc = tda.fedavg_baseline(s, t, cfg, rounds=5, device=CPU)
    assert 0.0 <= acc <= 1.0


# ---------------------------------------------------------------------------
# vertical FL (tests/test_vertical.py's cases)
# ---------------------------------------------------------------------------


def test_vertical_rff_matches_centralized_and_reference(rng):
    x = rng.normal(size=(20, 50)).astype(np.float32)
    xt = torch.tensor(x)
    blocks = [xt[:7], xt[7:12], xt[12:]]
    sig_v = tvert.vertical_rff(blocks, seed=3, n_features=64, sigma=1.5)
    omega = draw_omega(3, 64, 20, sigma=1.5, device=CPU)
    np.testing.assert_allclose(sig_v.numpy(), rff_features(xt, omega).numpy(), atol=1e-5)
    # with the reference's Omega, the reference's answer
    jom = jdraw_omega(3, 64, 20, sigma=1.5)
    ref = jvert.vertical_rff([jnp.asarray(x[:7]), jnp.asarray(x[7:12]), jnp.asarray(x[12:])],
                             seed=3, n_features=64, sigma=1.5)
    ours = tvert.assemble_rff([tvert.partial_phases(ob, xb) for ob, xb in zip(
        tvert.split_omega(_t(jom), [7, 5, 8]), blocks)])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(jrff_features(jnp.asarray(x), jom)),
                               atol=1e-5)


def test_split_omega_validates():
    om = torch.ones((4, 10))
    with pytest.raises(ValueError):
        tvert.split_omega(om, [3, 3])
    parts = tvert.split_omega(om, [4, 6])
    assert parts[0].shape == (4, 4) and parts[1].shape == (4, 6)


def test_vertical_rf_tca_end_to_end(rng):
    xs = rng.normal(size=(16, 60)).astype(np.float32)
    xt = (rng.normal(size=(16, 40)) + 1.0).astype(np.float32)
    x = torch.tensor(np.concatenate([xs, xt], axis=1))
    sig = tvert.vertical_rff([x[:5], x[5:11], x[11:]], seed=0, n_features=64)
    w, vals = solve_w_rf(sig, ell_vector(60, 40), 1e-2, 4)
    assert w.shape == (128, 4)
    assert np.isfinite(vals.numpy()).all()


# ---------------------------------------------------------------------------
# package surfaces
# ---------------------------------------------------------------------------


def test_core_reexports_the_reference_names():
    ref = {n for n in dir(jcore) if not n.startswith("_")} - {
        "kernels_math", "mmd", "rff", "tca", "theory", "rf_tca"}
    names = set(tcore.__all__)
    assert len(names) == 27 and ref | {"rf_tca"} == names
    for n in names:
        assert callable(getattr(tcore, n)), n
    from repro_torch.core import rf_tca as module  # still the submodule

    assert module.rf_tca_fit is tcore.rf_tca_fit
    xs, xt = np.ones((3, 4), np.float32), np.zeros((3, 5), np.float32)
    fs, ft, _ = tcore.rf_tca(xs, xt, n_features=8, m=2, device=CPU)
    assert fs.shape == (2, 4) and ft.shape == (2, 5)


def test_tree_helpers_match_reference(rng):
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": [np.ones(5, np.float32)]}
    ta = {"w": _t(a["w"]), "b": [_t(a["b"][0]).to(torch.bfloat16)]}
    ja = {"w": jnp.asarray(a["w"]), "b": [jnp.asarray(a["b"][0], jnp.bfloat16)]}
    assert tutils.tree_size(ta) == jutils.tree_size(ja) == 17
    assert tutils.tree_bytes(ta) == jutils.tree_bytes(ja) == 58
    z = tutils.tree_zeros_like(ta)
    assert z["b"][0].dtype == torch.bfloat16 and float(z["w"].abs().sum()) == 0
    assert tutils.tree_allclose(ta, ta) and jutils.tree_allclose(ja, ja)
    near = {"w": ta["w"] + 1e-7, "b": ta["b"]}
    assert tutils.tree_allclose(ta, near) == jutils.tree_allclose(
        ja, {"w": ja["w"] + 1e-7, "b": ja["b"]})
    assert not tutils.tree_allclose(ta, tutils.tree_zeros_like(ta))
    assert not tutils.tree_allclose(ta, {"w": ta["w"]})
