"""Port parity: ``repro_torch.core.tca`` and ``core.theory`` vs repro.

One kernel matrix (or one data matrix) from numpy goes through both packages
on the CPU; values agree to 1e-5 relative.  For the theory helpers the port's
``draw_omega`` is replaced by one returning the reference's draw, so both
sides see one Omega.  The second half mirrors tests/test_core.py:46-90,
127-137 and tests/test_theory.py on the port alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as jkm  # noqa: E402
from repro.core import rff as jrff  # noqa: E402
from repro.core import tca as jtca  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro_torch.core import mmd as tmmd  # noqa: E402
from repro_torch.core import rf_tca as trf  # noqa: E402
from repro_torch.core import tca as ttca  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core.kernels_math import (  # noqa: E402
    centering_matrix,
    ell_vector,
    gaussian_kernel,
)
from repro_torch.core.rff import draw_omega, rff_features  # noqa: E402

REL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, 60)).astype(np.float32)
    xt = (rng.normal(size=(8, 40)) + 1.0).astype(np.float32)
    x = np.concatenate([xs, xt], axis=1)
    ell = np.array(jkm.ell_vector(60, 40))
    return xs, xt, x, ell


@pytest.fixture
def ref_omega(monkeypatch):
    def draw(seed, n_features, dim, sigma=1.0, kernel="gauss", *, device=None):
        om = np.array(jrff.draw_omega(seed, n_features, dim, sigma=sigma, kernel=kernel))
        return torch.tensor(om, device=device)

    monkeypatch.setattr(ttheory, "draw_omega", draw)


def _cosines(a, b) -> np.ndarray:
    qa = np.linalg.qr(np.asarray(a, np.float64).T)[0]
    qb = np.linalg.qr(np.asarray(b, np.float64).T)[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


@pytest.mark.parametrize("fn", ["vanilla_tca", "r_tca"])
def test_tca_matches_reference(data, fn):
    _, _, x, ell = data
    k = np.array(jkm.gaussian_kernel(jnp.asarray(x), 2.0))
    j = getattr(jtca, fn)(jnp.asarray(k), jnp.asarray(ell), 1e-2, 6)
    t = getattr(ttca, fn)(torch.from_numpy(k), torch.from_numpy(ell), 1e-2, 6)
    assert tuple(t.features.shape) == (6, 100)
    np.testing.assert_allclose(t.eigvals.numpy(), np.asarray(j.eigvals), rtol=REL)
    assert _cosines(j.features, t.features).min() > 1 - 1e-4


def test_r_tca_matrix_matches_reference(data):
    _, _, x, ell = data
    k = np.array(jkm.gaussian_kernel(jnp.asarray(x), 2.0))
    a_j = np.asarray(jtca.r_tca_matrix(jnp.asarray(k), jnp.asarray(ell), 1e-2))
    a_t = ttca.r_tca_matrix(torch.from_numpy(k), torch.from_numpy(ell), 1e-2).numpy()
    np.testing.assert_allclose(a_t / np.abs(a_j).max(), a_j / np.abs(a_j).max(), atol=REL)


@pytest.mark.parametrize("fn,args", [
    ("kernel_approx_error", (64, 2.0, 3)),
    ("corollary1_error", ("ell", 1e-2, 64, 2.0, 0)),
    ("theorem1_feature_error", ("ell", 1e-2, 2, 128, 2.0, 1)),
    ("required_features", (2.0, 0.5)),
])
def test_theory_matches_reference(data, ref_omega, fn, args):
    _, _, x, ell = data
    j_args = [jnp.asarray(ell) if a == "ell" else a for a in args]
    t_args = [torch.from_numpy(ell) if a == "ell" else a for a in args]
    v_j = getattr(jtheory, fn)(jnp.asarray(x), *j_args)
    v_t = getattr(ttheory, fn)(torch.from_numpy(x), *t_args)
    assert v_t == pytest.approx(v_j, rel=REL)


# ---- mirrors of the reference's own tests, on the port ----------------------


@pytest.fixture(scope="module")
def tdata(data):
    xs, xt, x, ell = data
    return tuple(torch.from_numpy(a) for a in (xs, xt, x, ell))


def test_centering_matrix_idempotent():
    h = centering_matrix(10)
    assert torch.allclose(h @ h, h, atol=1e-6)


def test_vanilla_tca_eigvals_descending(tdata):
    _, _, x, ell = tdata
    res = ttca.vanilla_tca(gaussian_kernel(x, 2.0), ell, 1e-2, 6)
    assert (np.diff(res.eigvals.numpy()) <= 1e-5).all()
    assert tuple(res.features.shape) == (6, 100)


def test_r_tca_equals_generalized_eig(tdata):
    _, _, x, ell = tdata
    k = gaussian_kernel(x, 2.0)
    res = ttca.r_tca(k, ell, 1e-2, 4)
    a_r = ttca.r_tca_matrix(k, ell, 1e-2)
    vals = np.linalg.eigvalsh(a_r.double().numpy())[::-1][:4]
    assert np.allclose(res.eigvals.numpy(), vals, rtol=1e-3)


def test_rf_tca_reduces_projected_mmd(tdata):
    xs, xt, x, ell = tdata
    st = trf.rf_tca_fit(xs, xt, n_features=256, m=8, gamma=1e-2, sigma=2.0, seed=0,
                        device="cpu")
    raw = tmmd.mmd_rff(rff_features(x, st.omega), ell)
    proj = tmmd.mmd_projected(st.w_rf, tmmd.message(rff_features(xs, st.omega), 1.0),
                              tmmd.message(rff_features(xt, st.omega), -1.0))
    assert float(proj) < 0.1 * float(raw)


def test_rf_tca_out_of_sample(tdata):
    xs, xt, *_ = tdata
    st = trf.rf_tca_fit(xs, xt, n_features=128, m=8, gamma=1e-2, sigma=2.0, seed=0,
                        device="cpu")
    f_new = trf.rf_tca_transform(st, xs[:, :5])
    assert tuple(f_new.shape) == (8, 5) and bool(torch.isfinite(f_new).all())


def test_solve_w_rf_constraint(tdata):
    _, _, x, ell = tdata
    sig = rff_features(x, draw_omega(0, 64, x.shape[0], sigma=2.0, device="cpu"))
    w, vals = trf.solve_w_rf(sig, ell, 1e-2, 4)
    assert tuple(w.shape) == (128, 4)
    assert (np.diff(vals.numpy()) <= 1e-5).all()


def test_theorem2_error_decays_with_n(tdata):
    x = tdata[2][:, :80]
    errs = [np.mean([ttheory.kernel_approx_error(x, n, 2.0, s) for s in range(3)])
            for n in (32, 256, 2048)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[0] / errs[2] > 3.0  # eps ~ 1/sqrt(N): 64x N -> ~8x, with slack


def test_corollary1_and_theorem1_errors_decay(tdata):
    x = tdata[2][:, :80]
    ell = ell_vector(50, 30)
    errs = [ttheory.corollary1_error(x, ell, 1e-2, n, 2.0, 0) for n in (32, 512)]
    assert errs[1] < errs[0]
    errs = [np.mean([ttheory.theorem1_feature_error(x, ell, 1e-2, 2, n, 2.0, s)
                     for s in range(3)]) for n in (64, 4096)]
    assert errs[1] < errs[0]


def test_required_features_scaling(tdata):
    x = tdata[2][:, :80]
    n1 = ttheory.required_features(x, 2.0, 0.5)
    n2 = ttheory.required_features(x, 2.0, 0.25)
    assert np.isclose(n2 / n1, 4.0, rtol=1e-3)
