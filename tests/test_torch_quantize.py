"""Port parity: the K10 fake-quant (plain version on the CPU) vs repro.

The same inputs go through the reference's Pallas kernel (interpret mode),
its XLA twin and the port's plain version; stochastic rounding agrees bit
for bit because all of them are fed the same uniforms.  The port computes one
scale per row of a stacked (K, ...) payload; that is held against
``jax.vmap(QuantCodec(bits).roundtrip)`` fed the same per-client uniforms,
also bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import codecs as jcodecs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.quantize import fake_quant_pallas  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.comm import codecs as tcodecs  # noqa: E402
from repro_torch.kernels import quantize  # noqa: E402


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _one_payload(x, u, bits: int) -> np.ndarray:
    """The codec round trip of one payload: a stack of one row."""
    return quantize.fake_quant_rows(_t(x)[None], _t(u)[None], bits=bits)[0].numpy()


def _compiled_scale(x, qmax: int) -> np.float32:
    """The scale the reference's compiled wrapper computes: XLA turns
    ``absmax / qmax`` into ``absmax * (1 / qmax)`` (a constant reciprocal)."""
    absmax = np.float32(np.abs(np.asarray(x)).max())
    return absmax * (np.float32(1) / np.float32(qmax)) if absmax > 0 else np.float32(1)


@pytest.mark.parametrize("shape", [(512,), (512, 32), (7, 13), (1,), (1024, 5)])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_matches_reference_kernel_and_twin(shape, bits):
    """The shapes of tests/test_kernels.py:327, the same key derivation.

    The codec round trip (scale absmax / qmax, a true divide) equals the
    reference's eager twin bit for bit.  The kernel's own function, given
    the same (x, u, scale), equals the reference's Pallas kernel (interpret
    mode) bit for bit; ``ops.fake_quant`` passes that kernel the compiled
    scale, absmax * (1 / qmax), which can differ from absmax / qmax by one
    ULP, so the port's kernel is held against it with that scale."""
    key = jax.random.PRNGKey(sum(shape) + bits)
    x = jax.random.normal(key, shape)
    u = jax.random.uniform(jax.random.fold_in(key, 1), shape)
    qmax = (1 << (bits - 1)) - 1
    twin = np.asarray(jref.fake_quant_ref(x, u, bits=bits))
    np.testing.assert_array_equal(_one_payload(x, u, bits), twin)
    kernel = np.asarray(jops.fake_quant(x, u, bits=bits))
    scale = torch.tensor([_compiled_scale(x, qmax)])
    plain = quantize.fake_quant(_t(x).reshape(1, -1), _t(u).reshape(1, -1), scale, qmax=qmax)
    np.testing.assert_array_equal(plain.reshape(shape).numpy(), kernel)
    rows = -(-x.size // 1024) * 8  # (rows, 128) in blocks of 8 rows, as ops.fake_quant
    xp = jnp.pad(x.ravel(), (0, rows * 128 - x.size)).reshape(rows, 128)
    up = jnp.pad(u.ravel(), (0, rows * 128 - x.size)).reshape(rows, 128)
    s = np.float32(np.abs(np.asarray(x)).max()) / np.float32(qmax)  # the codec's scale
    pallas = np.asarray(fake_quant_pallas(xp, up, jnp.full((1, 1), s), qmax=qmax))
    flat = quantize.fake_quant(_t(xp).reshape(1, -1), _t(up).reshape(1, -1),
                               torch.tensor([s]), qmax=qmax)
    np.testing.assert_array_equal(flat.reshape(rows, 128).numpy(), pallas)
    assert quantize.LAUNCHES["fake_quant"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("bits", [8, 4])
def test_zero_tensor_quantizes_to_zero(bits):
    x = jnp.zeros((7, 13))
    u = jax.random.uniform(jax.random.PRNGKey(bits), (7, 13))
    port = _one_payload(x, u, bits)
    np.testing.assert_array_equal(port, np.asarray(jops.fake_quant(x, u, bits=bits)))
    assert not port.any()


@pytest.mark.parametrize("shape", [(64,), (32, 8)])
@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_rows_match_vmapped_codec_roundtrip(shape, bits):
    """One scale per client row == the reference's vmapped per-tensor round
    trip, with each client's uniforms drawn from its own split key."""
    k = 5
    base = jax.random.PRNGKey(17 * bits + len(shape))
    x = jax.random.normal(base, (k, *shape)) * jnp.arange(1, k + 1).reshape(
        (k,) + (1,) * len(shape))
    x = x.at[2].set(0.0)  # an all-zero client goes through scale 1
    keys = jax.random.split(jax.random.fold_in(base, 1), k)
    exp = np.asarray(jax.vmap(jcodecs.QuantCodec(bits).roundtrip)(x, keys))
    u = jax.vmap(lambda kk: jax.random.uniform(kk, shape, jnp.float32))(keys)
    rows = quantize.fake_quant_rows(_t(x), _t(u), bits=bits).numpy()
    codec = tcodecs.QuantCodec(bits).roundtrip(_t(x), _t(u)).numpy()
    np.testing.assert_array_equal(rows, exp)
    np.testing.assert_array_equal(codec, exp)


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_without_uniforms_rounds_half_up(bits):
    x = jax.random.normal(jax.random.PRNGKey(3), (3, 40))
    exp = np.asarray(jax.vmap(lambda r: jcodecs.QuantCodec(bits).roundtrip(r))(x))
    got = tcodecs.QuantCodec(bits).roundtrip(_t(x)).numpy()
    np.testing.assert_array_equal(got, exp)


def test_scale_and_argument_checks():
    x = torch.tensor([[0.0, 0.0], [-2.54, 1.0]])
    np.testing.assert_array_equal(quantize.quant_scale(x, 127).numpy(),
                                  np.float32([1.0, np.float32(2.54) / np.float32(127)]))
    with pytest.raises(ValueError):
        quantize.qmax_of(3)
    with pytest.raises(ValueError):
        quantize.fake_quant(x, x.to("meta"), quantize.quant_scale(x, 7), qmax=7)
