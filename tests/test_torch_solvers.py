"""Port parity: the omega-operand and dense RF-TCA fits and their solvers vs repro.

The reference's ``draw_omega`` uses ``jax.random``, which the port does not
reproduce; where a test goes through the port's fit, ``draw_omega`` in
``repro_torch.core.rf_tca`` is replaced by one that returns the reference's
draw as a tensor.  Only the random source is replaced, not the code under test.

Tolerances (the reference's own, tests/test_streaming_solver.py): eigh and
Cholesky eigenvalues to rtol 1e-4 and subspace cosines above 1 - 1e-4; LOBPCG
to rtol 1e-4 and cosines above 1 - 1e-3; the 5m >= 2N fallback to rtol 1e-5.
Whole fits: eigenvalues to rtol 1e-2 and the subspace (ROADMAP's north star),
transforms of a carried state to 1e-5 of max|F|, target accuracy within 0.02.
"""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as jkm  # noqa: E402
from repro.core import rff as jrff  # noqa: E402
from repro.data import domains as jdomains  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rf_tca as trf  # noqa: E402


def _jrf():
    return importlib.import_module("repro.core.rf_tca")


@pytest.fixture
def ref_omega(monkeypatch):
    """The port's fit draws Omega from the reference's ``draw_omega``."""
    def draw(seed, n_features, dim, sigma=1.0, kernel="gauss", *, device=None):
        om = np.array(jrff.draw_omega(seed, n_features, dim, sigma=sigma, kernel=kernel))
        return torch.tensor(om, device=device)

    monkeypatch.setattr(trf, "draw_omega", draw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, 90)).astype(np.float32)
    xt = (rng.normal(size=(8, 70)) + 1.0).astype(np.float32)
    return xs, xt


def _sigma_ell(data, n_features, seed=0):
    xs, xt = data
    x = np.concatenate([xs, xt], axis=1)
    ell = np.array(jkm.ell_vector(xs.shape[1], xt.shape[1]))
    om = jrff.draw_omega(seed, n_features, x.shape[0])
    sig = np.array(jrff.rff_features(jnp.asarray(x), om))
    return x, ell, np.array(om), sig


def _cosines(wa, wb) -> np.ndarray:
    qa = np.linalg.qr(np.asarray(wa, np.float64))[0]
    qb = np.linalg.qr(np.asarray(wb, np.float64))[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("solver", ["eigh", "cholesky"])
def test_solve_w_rf_matches_reference(data, solver):
    _, ell, _, sig = _sigma_ell(data, 64)
    w_t, v_t = trf.solve_w_rf(*_t(sig, ell), 1e-2, 6, solver=solver)
    for w_j, v_j in (_jrf().solve_w_rf_cholesky(jnp.asarray(sig), jnp.asarray(ell), 1e-2, 6),
                     _jrf().solve_w_rf(jnp.asarray(sig), jnp.asarray(ell), 1e-2, 6)):
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-4)
        assert _cosines(w_j, w_t).min() > 1 - 1e-4


def test_solve_w_rf_cholesky_matches_reference(data):
    _, ell, _, sig = _sigma_ell(data, 48, seed=3)
    w_t, v_t = trf.solve_w_rf_cholesky(*_t(sig, ell), 1e-2, 5)
    w_j, v_j = _jrf().solve_w_rf_cholesky(jnp.asarray(sig), jnp.asarray(ell), 1e-2, 5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-4)
    assert _cosines(w_j, w_t).min() > 1 - 1e-4


def test_lobpcg_matches_reference_and_eigh(data):
    x, ell, om, _ = _sigma_ell(data, 64)  # 2N = 128
    g_j, u_j = _jrf().streaming_gram(jnp.asarray(x), jnp.asarray(ell), jnp.asarray(om))
    g_h, u = trf.streaming_gram(*_t(x, ell, om))
    w_e, v_e = trf.solve_w_rf_gram(g_h, u, 1e-2, 8, solver="eigh")
    w_l, v_l = trf.solve_w_rf_gram(g_h, u, 1e-2, 8, solver="lobpcg", seed=3)
    w_j, v_j = _jrf().solve_w_rf_gram(g_j, u_j, 1e-2, 8, solver="lobpcg")
    for w, v in ((w_e, v_e), (w_j, np.asarray(v_j))):
        np.testing.assert_allclose(v_l.numpy(), np.asarray(v), rtol=1e-4)
        assert _cosines(w, w_l).min() > 1 - 1e-3


@pytest.mark.parametrize("m", [7, 8, 12])  # 5m >= 2N = 32 for all of these
def test_lobpcg_small_problem_falls_back(data, m):
    x, ell, om, _ = _sigma_ell(data, 16)
    g_h, u = trf.streaming_gram(*_t(x, ell, om))
    _, v = trf.solve_w_rf_gram(g_h, u, 1e-2, m, solver="lobpcg")
    _, v_e = trf.solve_w_rf_gram(g_h, u, 1e-2, m, solver="eigh")
    np.testing.assert_allclose(v.numpy(), v_e.numpy(), rtol=1e-5)
    g_j, u_j = _jrf().streaming_gram(jnp.asarray(x), jnp.asarray(ell), jnp.asarray(om))
    _, v_j = _jrf().solve_w_rf_gram(g_j, u_j, 1e-2, m, solver="lobpcg")
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-4)


def test_lobpcg_reports_non_convergence(data):
    """Stopping at the iteration limit warns; it does not switch to eigh."""
    x, ell, om, _ = _sigma_ell(data, 64)
    g_h, u = trf.streaming_gram(*_t(x, ell, om))
    with pytest.warns(trf.LobpcgNotConverged, match="of 8 eigenpairs converged after 1"):
        trf.solve_w_rf_gram(g_h, u, 1e-2, 8, solver="lobpcg", lobpcg_iters=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", trf.LobpcgNotConverged)
        trf.solve_w_rf_gram(g_h, u, 1e-2, 8, solver="lobpcg", lobpcg_tol=1e-2)


@pytest.mark.parametrize("mode,solver", [
    ("stream", "eigh"), ("stream", "lobpcg"), ("dense", "eigh"), ("dense", "cholesky"),
    ("dense", "lobpcg"),
])
@pytest.mark.parametrize("kernel", ["gauss", "laplace"])
def test_fit_matches_reference(data, ref_omega, mode, solver, kernel):
    xs, xt = data
    kw = dict(n_features=64, m=8, gamma=1e-2, sigma=2.0, seed=4, kernel=kernel, mode=mode,
              solver=solver)
    j_state = _jrf().rf_tca_fit(jnp.asarray(xs), jnp.asarray(xt), **kw)
    t_state = trf.rf_tca_fit(xs, xt, device="cpu", **kw)
    assert t_state.fused is None
    np.testing.assert_array_equal(t_state.omega.numpy(), np.asarray(j_state.omega))
    np.testing.assert_allclose(t_state.eigvals.numpy(), np.asarray(j_state.eigvals), rtol=1e-2)
    assert _cosines(j_state.w_rf, t_state.w_rf).min() > 1 - 1e-3


def test_fit_modes_agree(data):
    """Stream (eigh, lobpcg) and dense (cholesky) fits of one seed share Omega
    and agree (tests/test_streaming_solver.py:102)."""
    xs, xt = data
    kw = dict(n_features=64, m=8, gamma=1e-2, sigma=2.0, seed=0, device="cpu")
    dense = trf.rf_tca_fit(xs, xt, mode="dense", solver="cholesky", **kw)
    for solver in ("eigh", "lobpcg"):
        stream = trf.rf_tca_fit(xs, xt, mode="stream", solver=solver, **kw)
        assert torch.equal(stream.omega, dense.omega)
        np.testing.assert_allclose(stream.eigvals.numpy(), dense.eigvals.numpy(), rtol=1e-4)


def test_stream_cholesky_rejected_early(data):
    xs, xt = data
    with pytest.raises(ValueError, match="cholesky"):
        trf.rf_tca_fit(xs, xt, n_features=32, m=4, mode="stream", solver="cholesky",
                       device="cpu")


def test_transform_of_carried_omega_state_matches_reference(data):
    xs, xt = data
    j_state = _jrf().rf_tca_fit(jnp.asarray(xs), jnp.asarray(xt), n_features=96, m=6,
                                gamma=1e-2, sigma=2.0, seed=2)
    assert j_state.omega is not None and j_state.fused is None
    t_state = convert.state_from_reference(
        np.asarray(j_state.omega), np.asarray(j_state.w_rf), np.asarray(j_state.eigvals),
        j_state.fused, device="cpu",
    )
    assert t_state.fused is None
    for x in (xs, xt[:, :23]):
        f_j = np.asarray(_jrf().rf_tca_transform(j_state, jnp.asarray(x)))
        f_t = trf.rf_tca_transform(t_state, x).numpy()
        np.testing.assert_allclose(f_t / np.abs(f_j).max(), f_j / np.abs(f_j).max(), atol=1e-5)


def _centroid_accuracy(f_s, y_s, f_t, y_t) -> float:
    f_s, f_t = np.asarray(f_s, np.float64), np.asarray(f_t, np.float64)
    classes = np.unique(y_s)
    cents = np.stack([f_s[:, y_s == c].mean(axis=1) for c in classes], axis=1)
    d = ((f_t[:, :, None] - cents[:, None, :]) ** 2).sum(axis=0)
    return float((classes[d.argmin(axis=1)] == y_t).mean())


@pytest.mark.parametrize("mode,solver", [("stream", "eigh"), ("dense", "cholesky")])
def test_rf_tca_target_accuracy_matches_reference(ref_omega, mode, solver):
    doms = jdomains.make_domains(2, 200, dim=12, seed=4)
    xs, ys, xt, yt = doms[0].x, doms[0].y, doms[1].x[:, :120], doms[1].y[:120]
    sigma = jkm.median_sigma(jnp.asarray(np.concatenate([xs, xt], axis=1)))
    kw = dict(n_features=160, m=8, gamma=1e-2, sigma=sigma, seed=1, mode=mode, solver=solver)
    f_s_j, f_t_j, _ = _jrf().rf_tca(jnp.asarray(xs), jnp.asarray(xt), **kw)
    f_s_t, f_t_t, st = trf.rf_tca(xs, xt, device="cpu", **kw)
    assert st.omega is not None
    acc_j = _centroid_accuracy(f_s_j, ys, f_t_j, yt)
    acc_t = _centroid_accuracy(f_s_t.numpy(), ys, f_t_t.numpy(), yt)
    assert abs(acc_j - acc_t) <= 0.02, (acc_j, acc_t)
