"""Port parity: repro_torch's kernel modules (plain versions on the CPU) vs repro.

The reference side runs its Pallas kernels in interpret mode and its XLA
twins, as its own tests do.  Tolerances are the reference's: 2e-5 on the
feature map (K1, K7; tests/test_kernels.py:13), atol 2e-5 on G_H / max|G_H|
and on u (K2/K3, K5/K6; tests/test_kernels.py:57) and 1e-5 on G / max|G|
(K8; tests/test_kernels.py:41).  The CUDA kernels themselves are held against
these plain versions in ``test_torch_cuda.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as jkm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.prng import fused_omega as j_fused_omega  # noqa: E402
from repro_torch.core import kernels_math as tkm  # noqa: E402
from repro_torch.core import rf_tca as trf  # noqa: E402
from repro_torch.core import rff as trff  # noqa: E402
from repro_torch.kernels import centered_gram as tcentered  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rff as tkrff  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.prng import fused_omega_block_plain  # noqa: E402
from repro_torch.kernels import rff_gram_stream as tgram  # noqa: E402

ATOL = 2e-5


def _jrf():
    return importlib.import_module("repro.core.rf_tca")


def _case(p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(p, n)).astype(np.float32)
    ell = np.array(jkm.ell_vector(n // 2, n - n // 2), np.float32)
    return x, ell


def _assert_gram_close(g_ref, u_ref, g, u, atol=ATOL):
    g_ref = np.asarray(g_ref)
    scale = float(np.abs(g_ref).max())
    np.testing.assert_allclose(np.asarray(g) / scale, g_ref / scale, atol=atol, rtol=0)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref), atol=atol, rtol=0)


@pytest.mark.parametrize("ensemble", [1, 3])
@pytest.mark.parametrize("tile", [0, 128])
def test_fused_gram_plain_matches_pallas_interpret(ensemble, tile):
    x, ell = _case(7, 150, seed=tile + ensemble)
    kw = dict(n_features=96, seed=11, ensemble=ensemble)
    g_j, u_j = jops.rff_gram_stream_fused(jnp.asarray(x), jnp.asarray(ell), tile=tile, **kw)
    g_t, u_t = tops.rff_gram_stream_fused(torch.from_numpy(x), torch.from_numpy(ell), **kw)
    assert tuple(g_t.shape) == (192, 192) and tuple(u_t.shape) == (192,)
    _assert_gram_close(g_j, u_j, g_t, u_t)


@pytest.mark.parametrize("ensemble", [1, 3])
@pytest.mark.parametrize("tile", [0, 128])
def test_fused_gram_plain_matches_xla_twin(ensemble, tile):
    x, ell = _case(16, 256, seed=7 * ensemble + tile)
    kw = dict(n_features=160, seed=2**32 + 3, ensemble=ensemble, sigma=0.8)
    g_j, u_j = _jrf().fused_streaming_gram(
        jnp.asarray(x), jnp.asarray(ell), use_pallas=False, tile=tile, **kw
    )
    g_t, u_t = tops.rff_gram_stream_fused(
        torch.from_numpy(x), torch.from_numpy(ell), n_features=160, seed=2**32 + 3,
        ensemble=ensemble, sigma_rf=0.8,
    )
    _assert_gram_close(g_j, u_j, g_t, u_t)


def test_fused_gram_laplace_matches_reference():
    x, ell = _case(6, 110, seed=5)
    x = 0.3 * x  # Cauchy phases are heavy-tailed: keep them moderate at tiny N
    kw = dict(n_features=64, seed=3, ensemble=2, sigma=1.3, rf_kernel="laplace")
    g_j, u_j = jref.rff_gram_stream_fused_ref(jnp.asarray(x), jnp.asarray(ell), **kw)
    g_t, u_t = tref.rff_gram_stream_fused_ref(torch.from_numpy(x), torch.from_numpy(ell), **kw)
    _assert_gram_close(g_j, u_j, g_t, u_t)
    g_k, u_k = tops.rff_gram_stream_fused(
        torch.from_numpy(x), torch.from_numpy(ell), n_features=64, seed=3, ensemble=2,
        sigma_rf=1.3, rf_kernel="laplace",
    )
    _assert_gram_close(g_j, u_j, g_k, u_k, atol=3e-5)  # tests/test_kernels.py:261


def test_fused_gram_five_outputs_contract():
    """Draw e's moment columns sit at (2e, 2e+1); the Gram blocks pool draws."""
    x, ell = _case(5, 40, seed=1)
    xt, et = torch.from_numpy(x), torch.from_numpy(ell)
    gcc, gcs, gss, mc, ms = tgram.rff_gram_stream_fused_plain(
        xt, et, n_features=24, seed=4, ensemble=3
    )
    assert tuple(gcc.shape) == (24, 24) and tuple(mc.shape) == (24, 6)
    inv = tgram.feature_scale(24, 3)
    om1 = fused_omega_block_plain(4, 24, 5, ensemble_index=1, device="cpu")
    c1 = torch.cos(om1 @ xt) * inv
    np.testing.assert_allclose(mc[:, 2].numpy(), (c1 @ et).numpy(), atol=1e-6)
    np.testing.assert_allclose(mc[:, 3].numpy(), c1.sum(1).numpy(), atol=1e-6)
    np.testing.assert_allclose(gcc.numpy(), gcc.T.numpy(), atol=1e-6)


@pytest.mark.parametrize("p,n,nf", [(16, 64, 32), (33, 170, 77), (7, 256, 130)])
def test_rff_plain_matches_reference(p, n, nf):
    rng = np.random.default_rng(p * n)
    x = rng.normal(size=(p, n)).astype(np.float32)
    om = rng.normal(size=(nf, p)).astype(np.float32)
    out = trff.rff_features(torch.from_numpy(x), torch.from_numpy(om))
    assert tuple(out.shape) == (2 * nf, n)
    for ref in (jops.rff(jnp.asarray(x), jnp.asarray(om), block=64),
                jref.rff_ref(jnp.asarray(x), jnp.asarray(om))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        tref.rff_ref(torch.from_numpy(x), torch.from_numpy(om)).numpy(),
        np.asarray(jref.rff_ref(jnp.asarray(x), jnp.asarray(om))), atol=ATOL, rtol=ATOL,
    )


def test_rff_rows_and_message_match_reference():
    from repro.core import rff as jrff

    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 50)).astype(np.float32)
    om = rng.normal(size=(40, 12)).astype(np.float32)
    xt, omt = torch.from_numpy(x), torch.from_numpy(om)
    np.testing.assert_allclose(
        trff.rff_features_rows(xt.T.contiguous(), omt).numpy(),
        np.asarray(jrff.rff_features_rows(jnp.asarray(x.T), jnp.asarray(om))), atol=ATOL,
    )
    np.testing.assert_allclose(
        trff.rff_message(xt, omt, -1.0).numpy(),
        np.asarray(jrff.rff_message(jnp.asarray(x), jnp.asarray(om), -1.0)), atol=1e-6,
    )


def test_dense_oracles_match_reference():
    x, ell = _case(9, 70, seed=2)
    om = np.array(j_fused_omega(4, 48, 9))
    g_j, u_j = jref.rff_gram_stream_ref(jnp.asarray(x), jnp.asarray(om), jnp.asarray(ell))
    g_t, u_t = tref.rff_gram_stream_ref(
        torch.from_numpy(x), torch.from_numpy(om), torch.from_numpy(ell)
    )
    _assert_gram_close(g_j, u_j, g_t, u_t)
    sig = np.random.default_rng(0).normal(size=(20, 33)).astype(np.float32)
    np.testing.assert_allclose(
        tref.centered_gram_ref(torch.from_numpy(sig)).numpy(),
        np.asarray(jref.centered_gram_ref(jnp.asarray(sig))), atol=1e-4,
    )


@pytest.mark.parametrize("ensemble", [1, 3])
def test_assemble_streamed_gram_ensemble_matches_reference(ensemble):
    rng = np.random.default_rng(ensemble)
    nf, n = 10, 37
    a = rng.normal(size=(nf, nf)).astype(np.float32)
    blocks = [a @ a.T, rng.normal(size=(nf, nf)).astype(np.float32), a.T @ a]
    mc = rng.normal(size=(nf, 2 * ensemble)).astype(np.float32)
    ms = rng.normal(size=(nf, 2 * ensemble)).astype(np.float32)
    g_j, u_j = jkm.assemble_streamed_gram_ensemble(
        *map(jnp.asarray, blocks), jnp.asarray(mc), jnp.asarray(ms), n=n, ensemble=ensemble
    )
    g_t, u_t = tkm.assemble_streamed_gram_ensemble(
        *map(torch.from_numpy, blocks), torch.from_numpy(mc), torch.from_numpy(ms), n=n,
        ensemble=ensemble,
    )
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-6)
    g_f, u_f = tkm.assemble_streamed_gram(
        *map(torch.from_numpy, blocks), torch.from_numpy(mc[:, 0]), torch.from_numpy(ms[:, 0]),
        torch.from_numpy(mc[:, 1]), torch.from_numpy(ms[:, 1]), n=n, fold_n=nf,
    )
    g_fj, u_fj = jkm.assemble_streamed_gram(
        *map(jnp.asarray, blocks), jnp.asarray(mc[:, 0]), jnp.asarray(ms[:, 0]),
        jnp.asarray(mc[:, 1]), jnp.asarray(ms[:, 1]), n=n, fold_n=nf,
    )
    np.testing.assert_allclose(g_f.numpy(), np.asarray(g_fj), atol=1e-5)
    np.testing.assert_allclose(u_f.numpy(), np.asarray(u_fj), atol=1e-6)


def test_kernel_math_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 41)).astype(np.float32)
    y = rng.normal(size=(6, 17)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    pairs = [
        (tkm.pairwise_sq_dists(xt, yt), jkm.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y))),
        (tkm.gaussian_kernel(xt, 1.7), jkm.gaussian_kernel(jnp.asarray(x), 1.7)),
        (tkm.laplace_kernel(xt, 1.7, yt),
         jkm.laplace_kernel(jnp.asarray(x), 1.7, jnp.asarray(y))),
        (tkm.centering_matrix(9), jkm.centering_matrix(9)),
        (tkm.ell_vector(5, 3), jkm.ell_vector(5, 3)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5, rtol=1e-5)
    k = tkm.gaussian_kernel(xt, 2.0)
    np.testing.assert_allclose(
        float(tkm.intrinsic_dim(k)), float(jkm.intrinsic_dim(jnp.asarray(k.numpy()))), rtol=1e-4
    )
    big = rng.normal(size=(5, 1100)).astype(np.float32)  # exercises the subsample
    for arr in (x, big):
        assert tkm.median_sigma(torch.from_numpy(arr)) == pytest.approx(
            jkm.median_sigma(jnp.asarray(arr)), rel=1e-5
        )


def test_gram_tile_plan():
    for nf, n, s in [(1000, 3612, 1), (4096, 3612, 4), (96, 150, 3), (4096, 100000, 1)]:
        plan = tgram.gram_tile_plan(nf, n=n, ensemble=s)
        assert plan["block"] % tgram.FEATURIZE_COLS == 0
        assert plan["chunks"] * plan["block"] >= n > (plan["chunks"] - 1) * plan["block"]
        assert plan["workspace_bytes"] <= max(tgram.WORKSPACE_BYTES, 2 * nf * s * 4 * 256)
        # balanced: the padding of the last chunk is under one featurize tile
        assert plan["chunks"] * plan["block"] - n < tgram.FEATURIZE_COLS * plan["chunks"]


@pytest.mark.parametrize("nf,p,n", [(1000, 2048, 1), (1000, 2048, 64), (1000, 2048, 300),
                                     (4096, 2048, 300), (1000, 2048, 512), (4096, 2048, 3612),
                                     (65, 7, 795), (1000, 40, 795), (65, 2048, 3612)])
def test_rff_split_plan(nf, p, n):
    """K1 on a card of 132 SMs: output tiles fewer than the SMs split the
    k-tiles of p into slices of at least MIN_SPLIT_KT that cover p, each slice
    non-empty; a full-width call (928 tiles) and a short p are not split."""
    plan = tkrff.split_plan(nf, p, n, sms=132)
    n_kt = -(-p // tkrff.K_TILE)
    s, kps = plan["slices"], plan["kt_per_split"]
    assert s * kps >= n_kt > (s - 1) * kps
    assert plan["tiles"] == -(-n // tkrff.TILE_COLS) * -(-nf // tkrff.TILE_FEATS)
    assert plan["ctas"] == plan["tiles"] * s
    if s > 1:
        assert plan["tiles"] < 132 and kps >= tkrff.MIN_SPLIT_KT
        # the slices' phase sums, then their squared norms of rows and columns
        assert plan["workspace_bytes"] == 4 * s * (nf * n + nf + n)
    if (nf, n) in ((1000, 300), (1000, 64)):  # a transform request's width at the paper's N
        assert s > 1 and plan["ctas"] <= 132
    if plan["tiles"] >= 132 or n_kt < 2 * tkrff.MIN_SPLIT_KT:
        assert s == 1 and plan["workspace_bytes"] == 0


# (rows, k, centered): K5's and K2's Gram at N = 1000 over one chunk, K8's at
# 2N = 2000 and 8192, K6's chunks at N = 4096, S = 4, and small edges
GRAM_SPLITS = [(1000, 3840, False, 136, 4), (2000, 3612, True, 136, 4),
               (8192, 3612, True, 2080, 1), (4096, 8192, False, 2080, 1), (65, 800, False, 3, 3),
               (130, 795, True, 3, 3)]


@pytest.mark.parametrize("rows,k,centered,tiles,split", GRAM_SPLITS)
def test_gram_split_plan_depends_on_the_shape_alone(rows, k, centered, tiles, split):
    """The tensor-core Gram's k split: about four waves of an H100's 132 SMs
    where the tiles are fewer, at least 8 k-tiles a block, the blocks
    covering k; a function of the shape alone (no card is asked), so a fit
    rounds the same on any card, and its partial tiles are summed in split
    order (csrc/gram_tf32.cuh), which the sum's bits depend on."""
    plan = tgram.gram_split_plan(rows, k, centered=centered)
    assert plan == tgram.gram_split_plan(rows, k, centered=centered)
    n_kt = -(-k // tgram.GRAM_K_TILE)
    s, kps = plan["split"], plan["kt_per_split"]
    assert (plan["tiles"], s) == (tiles, split)
    assert s * kps >= n_kt > (s - 1) * kps and (s == 1 or kps >= 8)
    assert plan["workspace_bytes"] == (4 * tiles * s * 128 * 128 if s > 1 else 0)
    if s == 1:
        return
    # the partials of the blocks, added in split order twice, and in reverse
    rng = np.random.default_rng(rows + k)
    c = torch.from_numpy(rng.normal(size=(64, n_kt * 32)).astype(np.float32))
    parts = [c[:, 32 * kps * i:32 * kps * (i + 1)] @ c[:, 32 * kps * i:32 * kps * (i + 1)].T
             for i in range(s)]

    def added(order):
        total = parts[order[0]]
        for i in order[1:]:
            total = total + parts[i]
        return total

    first = added(range(s))
    assert torch.equal(first, added(range(s)))
    assert not torch.equal(first, added(range(s)[::-1]))


# K8 on bf16 Sigma (csrc/gram_bf16.cuh): k-tiles of 64; the smoke's 2N = 2000
# (split 4, as at fp32) and 8192, and a ragged edge whose 13 k-tiles stay whole
BF16_K_TILE = 64  # gram_bf16.cuh GB_BK, which the card tests read from the library
BF16_GRAM_SPLITS = [(2000, 3612, 136, 4, 15), (8192, 3612, 2080, 1, 57), (130, 795, 3, 1, 13),
                    (130, 3611, 3, 7, 9)]


@pytest.mark.parametrize("rows,k,tiles,split,kps", BF16_GRAM_SPLITS)
def test_gram_split_plan_at_bf16_k_tiles(rows, k, tiles, split, kps):
    """The bf16 centered Gram's split in k-tiles of 64, from the shape alone."""
    plan = tgram.gram_split_plan(rows, k, centered=True, k_tile=BF16_K_TILE)
    assert (plan["tiles"], plan["split"], plan["kt_per_split"]) == (tiles, split, kps)
    assert plan["workspace_bytes"] == (4 * tiles * split * 128 * 128 if split > 1 else 0)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(v))[1] - 8)


@pytest.mark.parametrize("p,n,nf", [(16, 64, 32), (33, 170, 77), (128, 128, 128), (7, 300, 130)])
def test_rff_bf16_matches_reference(p, n, nf):
    """K1 on bf16 X and Omega (tests/test_kernels.py:15-26's shapes): Sigma in
    bf16 from bf16 products summed in fp32, cos and sin in fp32, rounded once,
    as the reference's kernel (interpret mode); within its 2e-2 and within one
    bf16 ULP plus fp32's 2e-5 of it (near a zero of cos, the two fp32 phases'
    rounding moves a tiny value by more than its own bf16 ULP)."""
    rng = np.random.default_rng(p * n)
    x = rng.normal(size=(p, n)).astype(np.float32)
    om = rng.normal(size=(nf, p)).astype(np.float32)
    out = tops.rff(torch.from_numpy(x).bfloat16(), torch.from_numpy(om).bfloat16())
    ref = jops.rff(jnp.asarray(x, jnp.bfloat16), jnp.asarray(om, jnp.bfloat16), block=64)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert tuple(out.shape) == ref.shape == (2 * nf, n)
    got, want = out.float().numpy(), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp + ATOL).all()


@pytest.mark.parametrize("two_n,n", [(64, 128), (96, 210), (128, 64), (32, 500)])
def test_centered_gram_bf16_matches_reference(two_n, n):
    """K8 on bf16 Sigma (tests/test_kernels.py:29-40's shapes): G in fp32, mu
    the row mean rounded to bf16, both operands widened less mu, as the
    reference's kernel (interpret mode, mean-padded samples); within its 5e-2
    and 1e-5 of G / max|G|."""
    sig = np.random.default_rng(two_n + n).normal(size=(two_n, n)).astype(np.float32)
    g_t = tops.centered_gram(torch.from_numpy(sig).bfloat16())
    g_j = jops.centered_gram(jnp.asarray(sig, jnp.bfloat16), block=32)
    assert g_t.dtype == torch.float32 and g_j.dtype == jnp.float32
    g_j = np.asarray(g_j)
    err = np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max()
    assert err <= 1e-5 <= 5e-2


# ---- K2/K3: the streamed Gram with Omega an operand -------------------------


def _operand_case(p, n, nf, seed):
    x, ell = _case(p, n, seed)
    om = np.random.default_rng(seed + 1).normal(size=(nf, p)).astype(np.float32)
    return x, om, ell


@pytest.mark.parametrize("p,n,nf", [
    (16, 64, 32), (7, 300, 130), (33, 170, 77), (16, 129, 64), (5, 97, 33),
])
def test_operand_gram_matches_reference(p, n, nf):
    """Port (plain five outputs, ops assembly) vs the reference's untiled
    kernel (interpret mode) and its dense oracle; p = 5 and 7 are not
    multiples of the featurize k step, N = 77, 130 not of a tile."""
    x, om, ell = _operand_case(p, n, nf, seed=p + n + nf)
    xj, omj, ellj = jnp.asarray(x), jnp.asarray(om), jnp.asarray(ell)
    g_t, u_t = tops.rff_gram_stream(*map(torch.from_numpy, (x, om, ell)))
    assert tuple(g_t.shape) == (2 * nf, 2 * nf) and tuple(u_t.shape) == (2 * nf,)
    for g_j, u_j in (jops.rff_gram_stream(xj, omj, ellj, block=64, tile=0),
                     jref.rff_gram_stream_ref(xj, omj, ellj)):
        _assert_gram_close(g_j, u_j, g_t, u_t)


@pytest.mark.parametrize("p,n,nf,tile", [(16, 64, 32, 128), (7, 300, 130, 128),
                                         (16, 129, 300, 256), (5, 97, 33, 128)])
def test_operand_gram_matches_tiled_reference(p, n, nf, tile):
    """Against the reference's (i, j)-tiled kernel (K3) at a forced tile."""
    x, om, ell = _operand_case(p, n, nf, seed=p * n + nf)
    g_j, u_j = jops.rff_gram_stream(jnp.asarray(x), jnp.asarray(om), jnp.asarray(ell),
                                    block=64, tile=tile)
    g_t, u_t = tops.rff_gram_stream(*map(torch.from_numpy, (x, om, ell)))
    _assert_gram_close(g_j, u_j, g_t, u_t)


def test_operand_gram_five_outputs_contract():
    """Moments are (N, 2): [ell-moment, column sum], scaled by 1/sqrt(N)."""
    x, om, ell = _operand_case(6, 45, 20, seed=9)
    xt, omt, et = map(torch.from_numpy, (x, om, ell))
    gcc, gcs, gss, mc, ms = tgram.rff_gram_stream_plain(xt, omt, et)
    assert tuple(gcc.shape) == (20, 20) and tuple(mc.shape) == tuple(ms.shape) == (20, 2)
    s = torch.sin(omt @ xt) * tgram.feature_scale(20, 1)
    np.testing.assert_allclose(ms[:, 0].numpy(), (s @ et).numpy(), atol=1e-6)
    np.testing.assert_allclose(ms[:, 1].numpy(), s.sum(1).numpy(), atol=1e-6)
    np.testing.assert_allclose(gss.numpy(), (s @ s.T).numpy(), atol=1e-6)


@pytest.mark.parametrize("tile", [None, 128])
def test_streaming_gram_matches_reference(tile):
    """``rf_tca.streaming_gram`` vs the reference's (XLA scan, untiled and
    tiled), atol 3e-5 (tests/test_streaming_solver.py:38)."""
    x, om, ell = _operand_case(8, 160, 48 if tile is None else 200, seed=3)
    g_j, u_j = _jrf().streaming_gram(jnp.asarray(x), jnp.asarray(ell), jnp.asarray(om),
                                     block=37, tile=tile)
    g_t, u_t = trf.streaming_gram(*map(torch.from_numpy, (x, ell, om)))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=3e-5)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=3e-5)


# ---- K8: the centered Gram --------------------------------------------------


@pytest.mark.parametrize("two_n,n", [(64, 128), (96, 210), (128, 64), (32, 500), (40, 130),
                                     (130, 257)])
def test_centered_gram_matches_reference(two_n, n):
    """Port vs the reference's kernel (interpret mode, mean-padded samples) and
    its oracle, fp32, G / max|G| to atol 1e-5 (tests/test_kernels.py:41)."""
    sig = np.random.default_rng(two_n * n).normal(size=(two_n, n)).astype(np.float32)
    g_t = tops.centered_gram(torch.from_numpy(sig)).numpy()
    assert g_t.shape == (two_n, two_n)
    for g_j in (jops.centered_gram(jnp.asarray(sig), block=32),
                jops.centered_gram(jnp.asarray(sig)),
                jref.centered_gram_ref(jnp.asarray(sig))):
        g_j = np.asarray(g_j)
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(g_t / scale, g_j / scale, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        g_t, tcentered.centered_gram_plain(torch.from_numpy(sig)).numpy())


def test_dense_gram_matches_reference():
    x, om, ell = _operand_case(9, 120, 40, seed=5)
    sig = np.array(jref.rff_ref(jnp.asarray(x), jnp.asarray(om)))
    g_j, u_j = _jrf()._dense_gram(jnp.asarray(sig), jnp.asarray(ell), use_kernel=True)
    g_t, u_t = trf._dense_gram(torch.from_numpy(sig), torch.from_numpy(ell))
    _assert_gram_close(g_j, u_j, g_t, u_t)
    np.testing.assert_array_equal(g_t.numpy(), g_t.numpy().T)


# ---- K7: the seed-fused featurize -------------------------------------------


@pytest.mark.parametrize("p,n,nf", [(16, 64, 32), (7, 130, 96)])
@pytest.mark.parametrize("ensemble_index", [0, 1])
def test_rff_fused_matches_reference(p, n, nf, ensemble_index):
    """Port vs the reference's seed-fused featurize kernel (interpret mode) and
    ``rff_ref`` on its materialized draw, atol/rtol 2e-5
    (tests/test_kernels.py:274)."""
    x = np.random.default_rng(p * n).normal(size=(p, n)).astype(np.float32)
    kw = dict(n_features=nf, seed=2, ensemble_index=ensemble_index, sigma_rf=0.9)
    sig_t = tops.rff_fused(torch.from_numpy(x), **kw).numpy()
    assert sig_t.shape == (2 * nf, n)
    om = j_fused_omega(2, nf, p, ensemble_index=ensemble_index, sigma=0.9)
    for sig_j in (jops.rff_fused(jnp.asarray(x), **kw), jref.rff_ref(jnp.asarray(x), om)):
        np.testing.assert_allclose(sig_t, np.asarray(sig_j), atol=ATOL, rtol=ATOL)
    om_t = fused_omega_block_plain(2, nf, p, ensemble_index=ensemble_index, sigma=0.9,
                                   device="cpu")
    np.testing.assert_array_equal(sig_t, tkrff.rff_plain(torch.from_numpy(x), om_t).numpy())
