"""Port parity: repro_torch's seed-fused RF-TCA fit and transform vs repro.

The same numpy inputs (seeded synthetic domains) go through both packages
on the CPU.  Tolerances: eigenvalues to rtol 1e-2 (tests/test_kernels.py:199);
the spanned subspace through the projector of the orthonormalized W_RF (raw
eigenvectors are free up to sign and rotation); transforms to 1e-4 of max|F|;
nearest-centroid target accuracy within 0.02.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as jkm  # noqa: E402
from repro.core import mmd as jmmd  # noqa: E402
from repro.data import domains as jdomains  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import kernels_math as tkm  # noqa: E402
from repro_torch.core import mmd as tmmd  # noqa: E402
from repro_torch.core import rf_tca as trf  # noqa: E402
from repro_torch.data import domains as tdomains  # noqa: E402

EIG_RTOL = 1e-2
SUBSPACE_TOL = 1e-3
TRANSFORM_TOL = 1e-4


def _jrf():
    return importlib.import_module("repro.core.rf_tca")


def _domains(seed=0, n=160, dim=12):
    doms = jdomains.make_domains(2, n, dim=dim, seed=seed)
    xs, ys = doms[0].x, doms[0].y
    xt, yt = doms[1].x[:, :120], doms[1].y[:120]
    sigma = jkm.median_sigma(jnp.asarray(np.concatenate([xs, xt], axis=1)))
    return xs, ys, xt, yt, sigma


def _projector(w) -> np.ndarray:
    q, _ = np.linalg.qr(np.asarray(w, np.float64))
    return q @ q.T


def _assert_same_solution(j_state, t_state):
    np.testing.assert_allclose(
        t_state.eigvals.cpu().numpy(), np.asarray(j_state.eigvals), rtol=EIG_RTOL
    )
    dist = np.linalg.norm(_projector(j_state.w_rf) - _projector(t_state.w_rf.cpu()), 2)
    assert dist <= SUBSPACE_TOL, dist


def _carry(j_state):
    return convert.state_from_reference(
        None if j_state.omega is None else np.asarray(j_state.omega),
        np.asarray(j_state.w_rf), np.asarray(j_state.eigvals), j_state.fused, device="cpu",
    )


@pytest.mark.parametrize("n_features,ensemble,m,kernel", [
    (96, 1, 8, "gauss"), (192, 3, 8, "gauss"), (64, 2, 4, "gauss"), (128, 2, 6, "laplace"),
])
def test_fused_fit_matches_reference(n_features, ensemble, m, kernel):
    xs, _, xt, _, sigma = _domains()
    kw = dict(n_features=n_features, m=m, gamma=1e-2, sigma=sigma, w_rf="fused:7",
              ensemble=ensemble, kernel=kernel)
    j_state = _jrf().rf_tca_fit(jnp.asarray(xs), jnp.asarray(xt), **kw)
    t_state = trf.rf_tca_fit(xs, xt, device="cpu", **kw)
    assert t_state.omega is None and t_state.fused == (7, ensemble, sigma, kernel)
    assert tuple(t_state.w_rf.shape) == (2 * n_features, m)
    _assert_same_solution(j_state, t_state)


def test_fit_with_stats_matches_reference():
    xs, _, xt, _, sigma = _domains(seed=1)
    kw = dict(n_features=80, m=6, gamma=1e-2, sigma=sigma, w_rf="fused:3", ensemble=2)
    j_state, j_stats = _jrf().rf_tca_fit_with_stats(jnp.asarray(xs), jnp.asarray(xt), **kw)
    t_state, t_stats = trf.rf_tca_fit_with_stats(xs, xt, device="cpu", **kw)
    _assert_same_solution(j_state, t_state)
    g = np.asarray(j_stats["gram"])
    scale = float(np.abs(g).max())
    np.testing.assert_allclose(t_stats["gram"].numpy() / scale, g / scale, atol=2e-5)
    np.testing.assert_allclose(t_stats["u"].numpy(), np.asarray(j_stats["u"]), atol=2e-5)
    assert (t_stats["gamma"], t_stats["m"], t_stats["solver"]) == (1e-2, 6, "eigh")


def test_transform_of_carried_state_matches_reference():
    xs, _, xt, _, sigma = _domains(seed=2)
    j_state = _jrf().rf_tca_fit(
        jnp.asarray(xs), jnp.asarray(xt), n_features=128, m=8, gamma=1e-2, sigma=sigma,
        w_rf="fused:5", ensemble=3,
    )
    t_state = _carry(j_state)
    for x in (xs, xt[:, :37]):
        f_j = np.asarray(_jrf().rf_tca_transform(j_state, jnp.asarray(x)))
        f_t = trf.rf_tca_transform(t_state, x).numpy()
        assert f_t.shape == f_j.shape
        np.testing.assert_allclose(f_t / np.abs(f_j).max(), f_j / np.abs(f_j).max(),
                                   atol=TRANSFORM_TOL)


def test_resolve_from_carried_stats_matches_reference():
    xs, _, xt, _, sigma = _domains(seed=3)
    kw = dict(n_features=96, m=8, gamma=1e-2, sigma=sigma, w_rf="fused:9")
    j_state, j_stats = _jrf().rf_tca_fit_with_stats(jnp.asarray(xs), jnp.asarray(xt), **kw)
    # a drifted target mean changes u but not the merged Gram
    u_new = np.asarray(j_stats["u"]) * 0.5
    j_new = _jrf().rf_tca_resolve(
        j_stats["gram"], jnp.asarray(u_new), gamma=1e-2, m=8, fused_spec=j_state.fused
    )
    stats = convert.stats_from_reference(j_stats, device="cpu")
    t_new = trf.rf_tca_resolve(
        stats["gram"], torch.from_numpy(u_new.copy()), gamma=stats["gamma"], m=stats["m"],
        solver=stats["solver"], fused_spec=j_state.fused,
    )
    _assert_same_solution(j_new, t_new)
    assert t_new.fused == tuple(j_state.fused)


def _centroid_accuracy(f_s, y_s, f_t, y_t) -> float:
    f_s, f_t = np.asarray(f_s, np.float64), np.asarray(f_t, np.float64)
    classes = np.unique(y_s)
    cents = np.stack([f_s[:, y_s == c].mean(axis=1) for c in classes], axis=1)
    d = ((f_t[:, :, None] - cents[:, None, :]) ** 2).sum(axis=0)
    return float((classes[d.argmin(axis=1)] == y_t).mean())


def test_target_accuracy_matches_reference():
    xs, ys, xt, yt, sigma = _domains(seed=4, n=200)
    kw = dict(n_features=160, m=8, gamma=1e-2, sigma=sigma, w_rf="fused:1")
    f_s_j, f_t_j, _ = _jrf().rf_tca(jnp.asarray(xs), jnp.asarray(xt), **kw)
    f_s_t, f_t_t, _ = trf.rf_tca(xs, xt, device="cpu", **kw)
    acc_j = _centroid_accuracy(f_s_j, ys, f_t_j, yt)
    acc_t = _centroid_accuracy(f_s_t.numpy(), ys, f_t_t.numpy(), yt)
    assert abs(acc_j - acc_t) <= 0.02, (acc_j, acc_t)


def test_transform_memo_draws_once_and_caps():
    xs, _, xt, _, sigma = _domains(seed=5)
    state = trf.rf_tca_fit(xs, xt, n_features=32, m=4, gamma=1e-2, sigma=sigma,
                           w_rf="fused:123456", device="cpu")
    before = trf.fused_omega_cache_info()["regenerations"]
    a = trf.rf_tca_transform(state, xt)
    b = trf.rf_tca_transform(state, xt)
    assert torch.equal(a, b)
    assert trf.fused_omega_cache_info()["regenerations"] == before + 1
    for s in range(20):  # FIFO cap
        trf.fused_transform_omega(state._replace(fused=(1000 + s, 1, 1.0, "gauss")), 4)
    info = trf.fused_omega_cache_info()
    assert info["size"] == info["max"] == 16


def test_domains_copy_equals_reference():
    for kw in (dict(n_domains=3, n_per_domain=50, seed=2), dict(n_domains=1, n_per_domain=9)):
        for a, b in zip(jdomains.make_domains(**kw), tdomains.make_domains(**kw)):
            assert a.name == b.name
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.y, b.y)
    for a, b in zip(jdomains.make_implicit_domains(2, 20, seed=1),
                    tdomains.make_implicit_domains(2, 20, seed=1)):
        np.testing.assert_array_equal(a.x, b.x)


def test_mmd_matches_reference():
    rng = np.random.default_rng(0)
    sig = rng.normal(size=(20, 30)).astype(np.float32)
    ell = np.array(jkm.ell_vector(18, 12), np.float32)
    w = rng.normal(size=(20, 4)).astype(np.float32)
    msgs = rng.normal(size=(3, 20)).astype(np.float32)
    wts = np.array([1.0, 0.0, 2.0], np.float32)
    k = np.asarray(jkm.gaussian_kernel(jnp.asarray(sig)))
    t = {n: torch.from_numpy(v.copy()) for n, v in
         dict(sig=sig, ell=ell, w=w, msgs=msgs, wts=wts, k=k).items()}
    pairs = [
        (tmmd.mmd_rkhs(t["k"], t["ell"]), jmmd.mmd_rkhs(jnp.asarray(k), jnp.asarray(ell))),
        (tmmd.mmd_rff(t["sig"], t["ell"]), jmmd.mmd_rff(jnp.asarray(sig), jnp.asarray(ell))),
        (tmmd.message(t["sig"], -1.0), jmmd.message(jnp.asarray(sig), -1.0)),
        (tmmd.mmd_projected(t["w"], t["msgs"][0], t["msgs"][1]),
         jmmd.mmd_projected(jnp.asarray(w), jnp.asarray(msgs[0]), jnp.asarray(msgs[1]))),
        (tmmd.mmd_projected_multi(t["w"], t["msgs"], t["msgs"][0], t["wts"]),
         jmmd.mmd_projected_multi(jnp.asarray(w), jnp.asarray(msgs), jnp.asarray(msgs[0]),
                                  jnp.asarray(wts))),
        (tmmd.mmd_projected_multi(t["w"], t["msgs"], t["msgs"][0]),
         jmmd.mmd_projected_multi(jnp.asarray(w), jnp.asarray(msgs), jnp.asarray(msgs[0]))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert float(tkm.intrinsic_dim(t["k"])) > 1.0


def test_entry_points_take_the_reference_keywords():
    """``seed``, ``lobpcg_iters`` and ``lobpcg_tol`` are the reference's
    keywords of ``rf_tca_fit``, ``rf_tca_fit_with_stats``, ``rf_tca_resolve``
    and ``solve_w_rf_gram``; the stats carry ``seed``."""
    xs, _, xt, _, sigma = _domains(seed=6, n=80)
    kw = dict(n_features=48, m=4, gamma=1e-2, sigma=sigma, device="cpu")
    for extra in (dict(w_rf="fused:2"), dict(), dict(mode="dense")):
        state = trf.rf_tca_fit(xs, xt, seed=11, **kw, **extra)
        assert tuple(state.w_rf.shape) == (96, 4)
    state, stats = trf.rf_tca_fit_with_stats(xs, xt, seed=11, w_rf="fused:2", **kw)
    assert stats["seed"] == 11
    again = trf.rf_tca_resolve(stats["gram"], stats["u"], gamma=stats["gamma"], m=stats["m"],
                               solver="lobpcg", seed=stats["seed"], fused_spec=state.fused)
    np.testing.assert_allclose(again.eigvals.numpy(), state.eigvals.numpy(), rtol=1e-4)
    w, vals = trf.solve_w_rf_gram(stats["gram"], stats["u"], 1e-2, 4, solver="lobpcg",
                                  lobpcg_iters=200, lobpcg_tol=1e-6, seed=5)
    np.testing.assert_allclose(vals.numpy(), state.eigvals.numpy(), rtol=1e-4)


def test_stats_seed_round_trips_through_convert():
    xs, _, xt, _, sigma = _domains(seed=7, n=80)
    kw = dict(n_features=48, m=4, gamma=1e-2, sigma=sigma, w_rf="fused:4", seed=13,
              solver="lobpcg")
    j_state, j_stats = _jrf().rf_tca_fit_with_stats(jnp.asarray(xs), jnp.asarray(xt), **kw)
    stats = convert.stats_from_reference(j_stats, device="cpu")
    assert stats["seed"] == j_stats["seed"] == 13 and stats["solver"] == "lobpcg"
    _, t_stats = trf.rf_tca_fit_with_stats(xs, xt, device="cpu", **kw)
    assert t_stats["seed"] == 13
    t_new = trf.rf_tca_resolve(stats["gram"], stats["u"], gamma=stats["gamma"], m=stats["m"],
                               solver=stats["solver"], seed=stats["seed"],
                               fused_spec=j_state.fused)
    _assert_same_solution(j_state, t_new)
