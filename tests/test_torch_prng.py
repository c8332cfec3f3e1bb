"""Port parity: the threefry Omega stream of repro_torch vs repro (K4).

Bits must be equal; floats go through PyTorch's log1p/cos/tan against XLA's,
which differ by a few ULP.  Measured on the CPU: at most 5 ULP for gauss and
2 ULP for laplace, so the stated bound is 8 ULP of the larger magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import prng as jprng  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402

OMEGA_ULP = 8


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / spacing


@pytest.mark.parametrize("seed", [0, 11, 2**32 + 5, 2**40 + 123])
@pytest.mark.parametrize("ensemble_index", [0, 3])
def test_threefry_bits_equal_reference(seed, ensemble_index):
    rows, cols, r0, c0 = 48, 80, 5, 2**32 - 40  # the column counter wraps
    iota_r = jax.lax.broadcasted_iota(jnp.uint32, (rows, cols), 0)
    iota_c = jax.lax.broadcasted_iota(jnp.uint32, (rows, cols), 1)
    j0, j1 = jprng.threefry2x32(
        np.uint32(np.uint64(seed) & 0xFFFFFFFF), np.uint32(ensemble_index),
        jnp.uint32(r0) + iota_r, jnp.uint32(c0) + iota_c,
    )
    t0, t1 = tprng.threefry_bits(
        seed, rows, cols, row0=r0, col0=c0, ensemble_index=ensemble_index, device="cpu"
    )
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


@pytest.mark.parametrize("rf_kernel", ["gauss", "laplace"])
@pytest.mark.parametrize("sigma", [1.0, 0.7])
@pytest.mark.parametrize("seed,ensemble_index,row0,col0", [
    (0, 0, 0, 0), (3, 2, 17, 5), (2**32 + 9, 1, 128, 256),
])
def test_fused_omega_block_within_ulp_bound(rf_kernel, sigma, seed, ensemble_index, row0, col0):
    kw = dict(row0=row0, col0=col0, ensemble_index=ensemble_index, sigma=sigma,
              rf_kernel=rf_kernel)
    ref = jprng.fused_omega_block(seed, 96, 130, **kw)
    out = tprng.fused_omega_block(seed, 96, 130, device="cpu", **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (96, 130)
    assert _ulps(ref, out.numpy()).max() <= OMEGA_ULP


def test_fused_omega_tile_independent():
    """A block at an offset is the same slice of the full matrix."""
    kw = dict(sigma=0.7, rf_kernel="laplace", device="cpu")
    full = tprng.fused_omega(5, 64, 40, **kw)
    blk = tprng.fused_omega_block(5, 16, 8, row0=32, col0=24, **kw)
    assert torch.equal(full[32:48, 24:32], blk)


def test_fused_omega_unknown_kernel_raises():
    with pytest.raises(ValueError):
        tprng.fused_omega_block(0, 4, 4, rf_kernel="cosine", device="cpu")
