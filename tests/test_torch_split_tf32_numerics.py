"""The numerics of the seed-fused featurize and Gram on the tensor cores, modelled on the CPU.

``csrc/featurize_tf32.cuh`` (K7, K5/K6's first stage) and
``csrc/gram_tf32.cuh`` (K5/K6's Gram) run on the card only, so their
arithmetic is modelled here in plain torch: every operand value is split into
``hi = tf32(v)`` and ``lo = tf32(v - hi)`` (tf32 rounded to nearest, ties
away from zero: ``cvt.rna.tf32.f32``), and each k-step of 8 adds three
products into one fp32 accumulator in the kernel's order, the two small terms
first (``lo hi``, ``hi lo``, then ``hi hi``).  Each such addition rounds
toward zero, as the tensor cores' fp32 accumulation does (on an H100, K6's
G_H came out 2.1e-5 from plain before the fold below, where rounding to
nearest would give ~5e-7).  The featurize computes ``Z^T = X^T Omega^T``
that way, recomputes phases of |z| >= 64 as fp32's FMA chain over k in
order, and takes cos/sin; the Gram takes ``C C^T``, ``C S^T`` and
``S S^T`` over the chunk's columns, each draw's block padded to a whole
k-step as the workspace is, each row of its first operand less that
draw's mean (added back as ``a (B 1)^T``).  Both fold their wgmma
accumulator into a sum with fp32's rounding to nearest every stage of 32 of
k.  The moments keep their fp32 FFMA kernel.

The model is held to the kernels' gates (``chip_smoke.py`` phases 4 and 5,
``tests/test_torch_cuda.py``): atol 2e-5 on Sigma, and on G_H / max|G_H| and
u, against the port's plain versions and against the reference's Pallas
kernels in interpret mode.  Four cases record the design: a single tf32
product keeps 10 mantissa bits and misses both gates; without the fold the
truncations of one accumulator over a chunk's k of 2048 come to ~1e-5 of a
positive diagonal, half the gate; and on Cauchy phases up to ~1e4
(``tests/test_torch_cuda.py``'s laplace Gram case) no product that rounds
otherwise than fp32's FMA chain holds the gate, the float64 phase rounded
once included, so such phases are recomputed as that chain; and at phases
under ~0.2 the unshifted Gram lands farther from the float64 answer than
plain, the shifted one closer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as jkm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.kernels_math import assemble_streamed_gram_ensemble  # noqa: E402
from repro_torch.kernels import rff as tkrff  # noqa: E402
from repro_torch.kernels import rff_gram_stream as tgram  # noqa: E402
from repro_torch.kernels.prng import fused_omega_block_plain  # noqa: E402

ATOL = 2e-5
KSTEP = 8  # wgmma m64nNk8: the k of one tf32 product


def tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (10 mantissa bits), nearest, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def add_rz(acc: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """fp32 acc + float64 term, rounded toward zero (a tensor-core addition)."""
    exact = acc.double() + term
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def tf32_product(a: torch.Tensor, b: torch.Tensor, parts: int = 3, fold: int = 0) -> torch.Tensor:
    """a (M, K) b (N, K)^T as the kernels take it: k-steps of 8, each adding
    ``parts`` tf32 products (exact, summed) to the accumulator with rounding
    toward zero; three parts in the kernels' order, or one plain tf32
    product.  ``fold`` > 0 adds the accumulator into an fp32 sum (rounding
    to nearest) and restarts it every ``fold`` k-steps."""
    pad = (-a.shape[1]) % KSTEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    total = torch.zeros_like(acc)
    for step, k0 in enumerate(range(0, a.shape[1], KSTEP)):
        a8, b8 = a[:, k0:k0 + KSTEP], b[:, k0:k0 + KSTEP]
        if parts == 3:
            (ah, al), (bh, bl) = split(a8), split(b8)
            terms = ((al, bh), (ah, bl), (ah, bh))
        else:
            terms = ((tf32(a8), tf32(b8)),)
        for u, v in terms:
            acc = add_rz(acc, u.double() @ v.double().T)
        if fold and (step + 1) % fold == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


EXACT_PHASE = 64.0  # featurize_tf32.cuh FT_EXACT_PHASE


def fma_chain(om: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """om (N, p) @ x (p, n) as fp32's FMA chain over k in order."""
    acc = torch.zeros((om.shape[0], x.shape[1]), dtype=torch.float32)
    for k in range(om.shape[1]):
        acc = (acc.double() + om[:, k:k + 1].double() * x[k:k + 1].double()).float()
    return acc


FOLD = 4  # both kernels: a stage of 32 of k, 4 k-steps


def featurize_model(x, om, scale, parts=3, exact_phase=EXACT_PHASE, fold=FOLD):
    """(C, S) of one draw: Z^T = X^T Omega^T on the modelled tensor cores,
    folded every stage, phases of at least ``exact_phase`` recomputed as the
    FMA chain."""
    z = tf32_product(x.T.contiguous(), om, parts, fold).T
    if exact_phase is not None:
        z = torch.where(z.abs() >= exact_phase, fma_chain(om, x), z)
    return torch.cos(z) * scale, torch.sin(z) * scale


def fused_gram_model(x, ell, *, n_features, seed, ensemble, sigma, rf_kernel, parts=3,
                     fold=FOLD, exact_phase=EXACT_PHASE, shift=True):
    """The five outputs of ``rff_gram_stream_fused`` with both products
    modelled, the Gram's first operand shifted by its rows' means
    (``shift``)."""
    scale = tgram.feature_scale(n_features, ensemble)
    pad = (-x.shape[1]) % KSTEP
    cs, ss, mc, ms = [], [], [], []
    for e in range(ensemble):
        om = fused_omega_block_plain(seed, n_features, x.shape[0], ensemble_index=e, sigma=sigma,
                                     rf_kernel=rf_kernel, device="cpu")
        c, s = featurize_model(x, om, scale, parts, exact_phase)
        mc += [c @ ell, c.sum(dim=1)]
        ms += [s @ ell, s.sum(dim=1)]
        cs.append(torch.nn.functional.pad(c, (0, pad)))
        ss.append(torch.nn.functional.pad(s, (0, pad)))
    c, s = torch.cat(cs, dim=1), torch.cat(ss, dim=1)
    mc, ms = torch.stack(mc, dim=1), torch.stack(ms, dim=1)
    if not shift:
        return (tf32_product(c, c, parts, fold), tf32_product(c, s, parts, fold),
                tf32_product(s, s, parts, fold), mc, ms)
    # the shifts of the first operand: each row's mean per draw (one chunk
    # here), subtracted from every column of the draw's block, padding
    # included; the last chunk adds a (B 1)^T back, B 1 the moments' column
    # sums, as an FMA chain over the draws
    a_c, a_s = (m[:, 1::2] / x.shape[1] for m in (mc, ms))
    blk = x.shape[1] + pad
    c_a, s_a = (v - torch.repeat_interleave(a, blk, dim=1) for v, a in ((c, a_c), (s, a_s)))

    def shift_back(g, a, rs):
        corr = torch.zeros_like(g)
        for e in range(ensemble):
            corr = (corr.double() + a[:, e, None].double() * rs[None, :, e].double()).float()
        return g + corr

    return (tgram.mirror_upper(shift_back(tf32_product(c_a, c, parts, fold), a_c, mc[:, 1::2])),
            shift_back(tf32_product(c_a, s, parts, fold), a_c, ms[:, 1::2]),
            tgram.mirror_upper(shift_back(tf32_product(s_a, s, parts, fold), a_s, ms[:, 1::2])),
            mc, ms)


def _x(p, n, seed, scale):
    return (np.random.default_rng(seed).normal(size=(p, n)) * scale).astype(np.float32)


def _ell(n):
    return np.array(jkm.ell_vector(n // 2, n - n // 2), np.float32)


def _gram_err(g_ref, u_ref, g, u):
    g_ref, u_ref = np.asarray(g_ref, np.float64), np.asarray(u_ref, np.float64)
    eg = np.abs(np.asarray(g, np.float64) - g_ref).max() / np.abs(g_ref).max()
    return max(float(eg), float(np.abs(np.asarray(u, np.float64) - u_ref).max()))


# (N, p, n, ensemble index, sigma, kind, x scale): unit phases, |Omega X| up to
# ~40 at p = 256, and Cauchy phases kept moderate (0.3 x, as the card test does)
FEATURIZE_CASES = [
    (96, 40, 300, 0, 1.0, "gauss", 40 ** -0.5),
    (160, 256, 700, 1, 1.0, "gauss", 1.0),
    (200, 128, 517, 2, 4.0, "laplace", 0.3 * 128 ** -0.5),
]


@pytest.mark.parametrize("nf,p,n,e,sigma,kind,xs", FEATURIZE_CASES)
def test_split_featurize_holds_the_gate(nf, p, n, e, sigma, kind, xs):
    x = _x(p, n, seed=nf + p, scale=xs)
    xt = torch.from_numpy(x)
    om = fused_omega_block_plain(7, nf, p, ensemble_index=e, sigma=sigma, rf_kernel=kind,
                                 device="cpu")
    c, s = featurize_model(xt, om, tkrff.inv_sqrt(nf))
    model = torch.cat([c, s]).numpy()
    kw = dict(n_features=nf, seed=7, ensemble_index=e, rf_kernel=kind)
    plain = tkrff.rff_fused_plain(xt, sigma=sigma, **kw).numpy()
    pallas = np.asarray(jops.rff_fused(jnp.asarray(x), sigma_rf=sigma, interpret=True, **kw))
    for other in (plain, pallas):
        assert np.abs(model - other).max() <= ATOL


# (N, p, n, S, sigma, kind, x scale)
GRAM_CASES = [
    (96, 40, 300, 1, 1.0, "gauss", 40 ** -0.5),
    (300, 40, 700, 3, 0.8, "gauss", 40 ** -0.5),
    (200, 256, 517, 2, 1.0, "gauss", 0.2),
    (200, 40, 517, 2, 4.0, "laplace", 0.3 * 40 ** -0.5),
]


@pytest.mark.parametrize("nf,p,n,ens,sigma,kind,xs", GRAM_CASES)
def test_split_gram_holds_the_gate(nf, p, n, ens, sigma, kind, xs):
    x, ell = _x(p, n, seed=3 * nf + n, scale=xs), _ell(n)
    xt, et = torch.from_numpy(x), torch.from_numpy(ell)
    kw = dict(n_features=nf, seed=11, ensemble=ens, rf_kernel=kind)
    g_m, u_m = assemble_streamed_gram_ensemble(
        *fused_gram_model(xt, et, sigma=sigma, **kw), n=n, ensemble=ens)
    g_p, u_p = assemble_streamed_gram_ensemble(
        *tgram.rff_gram_stream_fused_plain(xt, et, sigma=sigma, **kw), n=n, ensemble=ens)
    g_j, u_j = jops.rff_gram_stream_fused(jnp.asarray(x), jnp.asarray(ell), sigma_rf=sigma,
                                          interpret=True, **kw)
    assert _gram_err(g_p, u_p, g_m, u_m) <= ATOL
    assert _gram_err(g_j, u_j, g_m, u_m) <= ATOL


@pytest.mark.parametrize("stage", ["featurize", "gram"])
def test_one_tf32_product_misses_the_gate(stage):
    """Why three products: one tf32 rounding of each operand leaves ~2^-11 of
    every term, far beyond 2e-5 at unit-scale phases; the split leaves ~2^-22."""
    nf, p, n = 160, 256, 700
    x = torch.from_numpy(_x(p, n, seed=5, scale=1.0 if stage == "featurize" else 0.2))
    if stage == "featurize":
        om = fused_omega_block_plain(3, nf, p, device="cpu")
        plain = tkrff.rff_plain(x, om)
        errs = [float((torch.cat(featurize_model(x, om, tkrff.inv_sqrt(nf), parts))
                       - plain).abs().max()) for parts in (3, 1)]
    else:
        ell = torch.from_numpy(_ell(n))
        kw = dict(n_features=nf, seed=3, ensemble=1, sigma=1.0, rf_kernel="gauss")
        g_p, u_p = assemble_streamed_gram_ensemble(
            *tgram.rff_gram_stream_fused_plain(x, ell, **kw), n=n, ensemble=1)
        errs = []
        for parts in (3, 1):
            g_m, u_m = assemble_streamed_gram_ensemble(
                *fused_gram_model(x, ell, parts=parts, **kw), n=n, ensemble=1)
            errs.append(_gram_err(g_p.numpy(), u_p.numpy(), g_m.numpy(), u_m.numpy()))
    three, one = errs
    assert three <= ATOL < one


def test_gram_fold_bounds_the_truncation():
    """Why the Gram folds its accumulator every stage: over a chunk's k of
    2048 (K6's at N = 4096, S = 4) one accumulator's truncations bias the
    positive diagonal by ~1e-5 of G_H's scale; folding every 32 columns
    leaves a small fraction of that."""
    nf, p, n = 128, 16, 2048
    x = torch.from_numpy(_x(p, n, seed=9, scale=0.75))
    ell = torch.from_numpy(_ell(n))
    kw = dict(n_features=nf, seed=5, ensemble=1, sigma=1.0, rf_kernel="gauss")
    g_p, u_p = assemble_streamed_gram_ensemble(
        *tgram.rff_gram_stream_fused_plain(x, ell, **kw), n=n, ensemble=1)
    errs = []
    for fold in (FOLD, 0):
        g_m, u_m = assemble_streamed_gram_ensemble(
            *fused_gram_model(x, ell, fold=fold, **kw), n=n, ensemble=1)
        errs.append(_gram_err(g_p.numpy(), u_p.numpy(), g_m.numpy(), u_m.numpy()))
    folded, unfolded = errs
    assert folded <= ATOL / 10 and unfolded > 5 * folded


def test_large_phases_take_the_fma_chain():
    """The card test's laplace Gram case: unscaled X and Cauchy draws at
    sigma 4 give phases up to ~1e4, where one ULP of z moves cos by ~1e-3.
    The split products alone, and even the float64 phase rounded once, land
    beyond the gate from plain; recomputing |z| >= 64 as the FMA chain holds it."""
    nf, ens, n = 200, 2, 700
    x = torch.from_numpy(np.random.default_rng(nf).normal(size=(40, n)).astype(np.float32))
    ell = torch.from_numpy(_ell(n))
    kw = dict(n_features=nf, seed=5, ensemble=ens, sigma=4.0, rf_kernel="laplace")
    g_p, u_p = assemble_streamed_gram_ensemble(
        *tgram.rff_gram_stream_fused_plain(x, ell, **kw), n=n, ensemble=ens)

    def err(**model_kw):
        g_m, u_m = assemble_streamed_gram_ensemble(
            *fused_gram_model(x, ell, **kw, **model_kw), n=n, ensemble=ens)
        return _gram_err(g_p.numpy(), u_p.numpy(), g_m.numpy(), u_m.numpy())

    assert err() <= ATOL / 5
    assert err(exact_phase=None) > ATOL
    # the float64 phase rounded once, with exact Gram products
    scale = tgram.feature_scale(nf, ens)
    blocks = []
    for e in range(ens):
        om = fused_omega_block_plain(5, nf, 40, ensemble_index=e, sigma=4.0,
                                     rf_kernel="laplace", device="cpu")
        z = (om.double() @ x.double()).float()
        blocks.append((torch.cos(z) * scale, torch.sin(z) * scale))
    c = torch.cat([b[0] for b in blocks], dim=1).double()
    s = torch.cat([b[1] for b in blocks], dim=1).double()
    mom = [torch.stack(sum([[b[i].double() @ ell.double(), b[i].double().sum(1)]
                            for b in blocks], []), dim=1) for i in (0, 1)]
    g_x, u_x = assemble_streamed_gram_ensemble(c @ c.T, c @ s.T, s @ s.T, *mom, n=n,
                                               ensemble=ens)
    assert _gram_err(g_p.numpy(), u_p.numpy(), g_x.numpy(), u_x.numpy()) > ATOL


@pytest.mark.parametrize("nf,ens,p,n,seed", [(65, 1, 40, 795, 1), (96, 2, 16, 600, 2)])
def test_gram_shift_holds_small_phases(nf, ens, p, n, seed):
    """Why the Gram takes each row less its mean: at sigma 28 on a few rows
    of unit-variance-ish data the phases stay under ~0.2, every row of C is
    nearly constant and G_H is a cancellation of G_cc.  The unshifted split
    products then land farther from the float64 answer than plain does
    (``chip_smoke.py``'s N = 65 edge on 40 rows: 1.5e-5 against 1.2e-5 on
    an H100); the shifted ones land closer than plain."""
    x = torch.from_numpy(_x(p, n, seed=seed, scale=0.44))
    ell = torch.from_numpy(_ell(n))
    kw = dict(n_features=nf, seed=seed, ensemble=ens, sigma=28.0, rf_kernel="gauss")
    g_p, _ = assemble_streamed_gram_ensemble(
        *tgram.rff_gram_stream_fused_plain(x, ell, **kw), n=n, ensemble=ens)
    scale = tgram.feature_scale(nf, ens)
    cs, ss = [], []
    for e in range(ens):
        om = fused_omega_block_plain(seed, nf, p, ensemble_index=e, sigma=28.0, device="cpu")
        z = om.double() @ x.double()
        cs.append(torch.cos(z) * scale)
        ss.append(torch.sin(z) * scale)
    mom = [torch.stack([m for b in blocks for m in (b @ ell.double(), b.sum(dim=1))], dim=1)
           for blocks in (cs, ss)]
    c, s = torch.cat(cs, dim=1), torch.cat(ss, dim=1)
    g_x, _ = assemble_streamed_gram_ensemble(c @ c.T, c @ s.T, s @ s.T, *mom, n=n, ensemble=ens)

    def from_exact(g):
        return float((g.double() - g_x).abs().max() / g_x.abs().max())

    shifted, unshifted = (
        from_exact(assemble_streamed_gram_ensemble(
            *fused_gram_model(x, ell, shift=sh, **kw), n=n, ensemble=ens)[0])
        for sh in (True, False))
    assert shifted <= from_exact(g_p) / 1.5 and unshifted > 1.5 * shifted
