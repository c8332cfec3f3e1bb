"""The numerics of the bf16 dense statistics on the bf16 tensor cores, modelled on the CPU.

``csrc/gram_bf16.cuh`` (K8 on bf16 Sigma) and ``csrc/featurize_bf16.cuh`` (K1
on bf16 X and Omega) run on the card only, so their arithmetic is modelled
here in plain torch, as ``tests/test_torch_split_tf32_numerics.py`` models
the tf32 kernels.

K8: Sigma with zero columns up to a whole k-tile of 64 (TMA's fill), both
operands ``c = a - mu`` (mu the row mean rounded to bf16; c in fp32), the
columns past n set to 0 after the shift; c split into ``hi = bf16(c)`` and
``lo = bf16(c - hi)`` (round to nearest even), whose sum is c.  Each k-step
of 16 adds four products (exact, summed) to one fp32 accumulator in the
kernel's order (``lo lo``, ``lo hi``, ``hi lo``, ``hi hi``), each addition
rounding toward zero as the tensor cores' does; every 8 k-steps (two stages
of 64) the accumulator is added into the sum with fp32's rounding to
nearest.  The k axis is split as
``gram_split_plan`` splits it at k-tiles of 64, each split folding from its
own start, the partials added in split order; the upper tiles mirrored.

K1: the bf16 products exact, summed over a k-step of 16 and added to the
accumulator with rounding toward zero, a fold every 16 k-steps (four
stages), cos and sin of the fp32 phase times f32(1)/sqrt(N), rounded to bf16
once.

The models are held to the kernels' gates (``chip_smoke.py``,
``tests/test_torch_cuda.py``): K8 within 1e-5 of G / max|G| of plain or, where
plain is itself past that from the float64 answer, no farther from it; K1
within one bf16 ULP plus 2e-5 of plain; against the port's plain versions
and the reference's Pallas kernels in interpret mode.  Four cases record
the design: one uncentred bf16 product with the rank-one correction (a
quarter of the work) misses K8's gate on nearly constant rows, up to ~8x,
where the parts hold it; three products (``lo lo`` left out) miss it on
rows of many equal elements far below their mean; one K8 accumulator over
all of n misses it on nearly constant rows; and one K1 accumulator over p =
2048 moves unit-scale phases' outputs by more than a bf16 ULP.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import centered_gram as tcg  # noqa: E402
from repro_torch.kernels import rff as tkrff  # noqa: E402
from repro_torch.kernels import rff_gram_stream as tgram  # noqa: E402

KSTEP = 16  # wgmma m64nNk16: the k of one bf16 product
K_TILE = 64  # a stage: one 128-byte swizzled row of bf16 (gram_bf16.cuh GB_BK)
K8_FOLD = 8  # gram_bf16.cuh: two stages a fold
K1_FOLD = 16  # featurize_bf16.cuh FB_FOLD: four stages
CENTERED_ATOL = 1e-5  # tests/test_kernels.py:41, on G / max|G|
RFF_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def bf16(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 (8 significant bits, round to nearest even) -> fp32."""
    return v.bfloat16().float()


def parts(c: torch.Tensor):
    hi = bf16(c)
    return hi, bf16(c - hi)


def add_rz(acc: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """fp32 acc + float64 term, rounded toward zero (a tensor-core addition)."""
    exact = acc.double() + term
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def bf16_product(a: torch.Tensor, b: torch.Tensor, fold: int, split: bool,
                 lo_lo: bool = True) -> torch.Tensor:
    """a (M, K) b (N, K)^T in fp32 as the kernels take it: k-steps of 16, each
    adding its products (exact, summed) to the accumulator with rounding
    toward zero: four for ``split`` operands (``lo lo``, ``lo hi``, ``hi
    lo``, ``hi hi`` of their bf16 parts; ``lo_lo`` False leaves the first
    out), one for bf16 operands.  ``fold`` > 0 adds the
    accumulator into an fp32 sum (rounding to nearest) and restarts it every
    ``fold`` k-steps."""
    pad = (-a.shape[1]) % KSTEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    total = torch.zeros_like(acc)
    for step, k0 in enumerate(range(0, a.shape[1], KSTEP)):
        a16, b16 = a[:, k0:k0 + KSTEP], b[:, k0:k0 + KSTEP]
        if split:
            (ah, al), (bh, bl) = parts(a16), parts(b16)
            terms = ((al, bl),) * lo_lo + ((al, bh), (ah, bl), (ah, bh))
        else:
            terms = ((a16, b16),)
        for u, v in terms:
            acc = add_rz(acc, u.double() @ v.double().T)
        if fold and (step + 1) % fold == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


def centered_model(sig: torch.Tensor, fold: int = K8_FOLD, lo_lo: bool = True) -> torch.Tensor:
    """K8 on bf16 Sigma as gram_bf16.cuh takes it (see the module's note)."""
    rows, n = sig.shape
    plan = tgram.gram_split_plan(rows, n, centered=True, k_tile=K_TILE)
    padded = torch.nn.functional.pad(sig.float(), (0, (-n) % K_TILE))
    c = padded - tcg.row_mean(sig)
    c[:, n:] = 0.0
    step = plan["kt_per_split"] * K_TILE
    g = None
    for k0 in range(0, c.shape[1], step):
        blk = c[:, k0:k0 + step]
        part = bf16_product(blk, blk, fold, split=True, lo_lo=lo_lo)
        g = part if g is None else g + part
    return tgram.mirror_upper(g)


def rank_one_model(sig: torch.Tensor, fold: int = K8_FOLD) -> torch.Tensor:
    """The route not taken: one uncentred product of the bf16 operands (exact
    products), then G = S S^T - s mu^T - mu s^T + n mu mu^T in fp32, s the
    rows' sums."""
    s = sig.float()
    mu = tcg.row_mean(sig)
    rs = s.sum(dim=1, keepdim=True)
    g = bf16_product(s, s, fold, split=False)
    return tgram.mirror_upper(g - rs @ mu.T - mu @ rs.T + sig.shape[1] * (mu @ mu.T))


def k8_distances(g: torch.Tensor, sig: torch.Tensor) -> dict:
    """G / max|G| from plain, and the kernel's and plain's distances from the
    float64 answer on the same operands (Sigma less its bf16 mean)."""
    plain = tcg.centered_gram_plain(sig)
    c = sig.double() - tcg.row_mean(sig).double()
    exact = c @ c.T
    scale = float(exact.abs().max())
    return dict(err=float((g - plain).abs().max() / plain.abs().max()),
                kernel=float((g.double() - exact).abs().max()) / scale,
                plain=float((plain.double() - exact).abs().max()) / scale)


def holds_k8_gate(d: dict) -> bool:
    return d["err"] <= CENTERED_ATOL or d["kernel"] <= d["plain"]


def _normal_sigma(rows, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(rows, n))
                            .astype(np.float32)).bfloat16()


def _sigma28(rows, p, n, seed):
    """bf16 Sigma of K1 at sigma 28 on p rows of the smoke's scale
    (``chip_smoke.py``'s ``K8_EDGES``): phases under ~0.2, so each cos row
    is a few bf16 steps of its mean and G cancels."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.44 * rng.normal(size=(p, n))).astype(np.float32))
    om = torch.from_numpy((rng.normal(size=(rows // 2, p)) / 28.0).astype(np.float32))
    return tkrff.rff_plain(x.bfloat16(), om.bfloat16())


# tests/test_kernels.py:29's sweep and a ragged shape (2N not a multiple of
# 128, n not of 8 or 64)
SWEEP = [(64, 128), (96, 210), (128, 64), (32, 500), (130, 797)]


@pytest.mark.parametrize("rows,n", SWEEP)
def test_k8_parts_hold_the_gate_on_the_sweep(rows, n):
    """K8 on normal bf16 Sigma: the model within 1e-5 of plain, and of the
    reference's kernel (interpret mode, block 32)."""
    sig = _normal_sigma(rows, n, seed=rows + n)
    g = centered_model(sig)
    assert k8_distances(g, sig)["err"] <= CENTERED_ATOL
    g_j = np.asarray(jops.centered_gram(jnp.asarray(sig.float().numpy(), jnp.bfloat16), block=32))
    assert float(np.abs(g.numpy() - g_j).max() / np.abs(g_j).max()) <= CENTERED_ATOL
    assert torch.equal(g, g.T)


# K8_EDGES's nearly constant rows in bf16 (N = 65 on 7 and 40 rows of X, and
# n = 3611, where the k split is 7 ways)
EDGES = [(130, 7, 795), (130, 40, 795), (130, 7, 3611)]


@pytest.mark.parametrize("rows,p,n", EDGES)
def test_k8_parts_hold_the_gate_on_nearly_constant_rows(rows, p, n):
    sig = _sigma28(rows, p, n, seed=rows + p + n)
    assert holds_k8_gate(k8_distances(centered_model(sig), sig))


def test_k8_rank_one_route_misses_nearly_constant_rows():
    """Why the parts: the uncentred product with the rank-one correction
    keeps exact bf16 products and would take a third of the work, and it
    holds the gate on normal rows; on nearly constant rows its fp32 sum of
    n mu_i mu_j-sized terms cancels to G's size, missing K8's gate ~8x and
    the float64 rule ~100x (7.9e-5 of max|G| at n = 3611, plain 8e-7 from
    float64; 1.3x-4.9x at n = 795), where the parts land within 5e-6."""
    sig = _sigma28(130, 7, 3611, seed=130 + 7 + 3611)
    one = k8_distances(rank_one_model(sig), sig)
    assert one["err"] > 5 * CENTERED_ATOL and one["kernel"] > 50 * one["plain"]
    assert k8_distances(centered_model(sig), sig)["kernel"] <= CENTERED_ATOL / 2
    normal = _normal_sigma(96, 210, seed=306)
    assert holds_k8_gate(k8_distances(rank_one_model(normal), normal))


def _repeated_sigma(rows, n, seed, frac=0.9, tiny=2.0 ** -12):
    """bf16 Sigma whose rows hold one small value, under |mu| / 256, in a
    fraction ``frac`` of their elements and values in [1.5, 3) elsewhere:
    every such element's c is the same, so its ``lo`` (up to 2^-8 of |c|)
    repeats along the row."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(1.5, 3.0, size=(rows, n))
    small = np.broadcast_to(rng.uniform(1.0, 2.0, size=(rows, 1)) * tiny, (rows, n))
    return torch.from_numpy(np.where(rng.random((rows, n)) < frac, small, big)
                            .astype(np.float32)).bfloat16()


def test_k8_parts_sum_to_c_for_every_bf16_pair():
    """hi + lo is fp32's a - mu for every finite bf16 a against every bf16 mu
    in [1, 2) (and so, scaled, against any normal mu): near in size, c - hi
    has at most 8 significant bits; where |a| is under half a bf16 step of
    mu, hi = -mu and lo = a.  |lo| reaches 2^-8 of |c|."""
    a = (torch.arange(65536, dtype=torch.int32) << 16).view(torch.float32)
    a = a[torch.isfinite(a)]
    worst = 0.0
    for mu in ((torch.arange(0x3F80, 0x4000, dtype=torch.int32)) << 16).view(torch.float32):
        c = a - mu
        hi, lo = parts(c)
        assert torch.equal(hi.double() + lo.double(), c.double())
        worst = max(worst, float((lo.abs() / c.abs()).nan_to_num(0.0).max()))
    assert 2.0 ** -8 * 0.99 < worst <= 2.0 ** -8


@pytest.mark.parametrize("rows,n,frac", [(64, 500, 0.9), (130, 3611, 0.9), (64, 500, 0.99),
                                         (96, 797, 0.7)])
def test_k8_parts_hold_the_float64_rule_on_repeated_small_elements(rows, n, frac):
    """Rows of many equal elements far below their mean: the four products
    add c_a c_b exactly a k-step, and the model is no farther from the
    float64 answer than plain."""
    sig = _repeated_sigma(rows, n, seed=rows + n, frac=frac)
    d = k8_distances(centered_model(sig), sig)
    assert d["kernel"] <= d["plain"] and d["err"] <= CENTERED_ATOL


def _tie_sigma(rows, n, seed):
    """bf16 Sigma whose rows hold 2^-8 in a tenth of their elements (at
    places drawn from ``seed``) and 1.1171875 elsewhere: mu rounds to 1 +
    2^-7, so c = 2^-8 - mu = -(1 + 2^-8) is a tie between two bf16 values,
    hi = -1 and lo = -2^-8, the largest lo for its c."""
    rng = np.random.default_rng(seed)
    sig = np.full((rows, n), 1.1171875, np.float32)
    for r in range(rows):
        sig[r, rng.permutation(n)[:n // 10]] = 2.0 ** -8
    return torch.from_numpy(sig).bfloat16()


@pytest.mark.parametrize("rows,n", [(64, 500), (130, 3610)])
def test_k8_three_products_miss_repeated_small_elements(rows, n):
    """Why ``lo lo`` is kept: left out, its terms repeat along rows of equal
    small elements and add up to 1.37e-5 of max|G|, past K8's gate and the
    float64 rule (plain within 1.2e-7); the four products land on plain's
    distance from the float64 answer."""
    sig = _tie_sigma(rows, n, seed=rows + n)
    assert float(tcg.row_mean(sig).min()) == float(tcg.row_mean(sig).max()) == 1.0078125
    three = k8_distances(centered_model(sig, lo_lo=False), sig)
    assert not holds_k8_gate(three) and three["kernel"] > 1.3 * CENTERED_ATOL
    four = k8_distances(centered_model(sig), sig)
    assert four["kernel"] <= four["plain"] and four["err"] <= CENTERED_ATOL


def test_k8_fold_bounds_the_truncation():
    """Why K8 folds every two stages: one accumulator over n = 3611 (no k
    split) truncates its way past K8's gate and the float64 rule; the fold
    stays within half the gate."""
    sig = _sigma28(130, 7, 3611, seed=130 + 7 + 3611)
    c = torch.nn.functional.pad(sig.float(), (0, (-3611) % K_TILE)) - tcg.row_mean(sig)
    c[:, 3611:] = 0.0
    one = k8_distances(tgram.mirror_upper(bf16_product(c, c, 0, split=True)), sig)
    folded = k8_distances(tgram.mirror_upper(bf16_product(c, c, K8_FOLD, split=True)), sig)
    assert not holds_k8_gate(one)
    assert folded["err"] <= CENTERED_ATOL / 2


def _bf16_units(k: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest difference in units of one bf16 ULP of the larger plus
    2e-5."""
    k, plain = k.float(), plain.float()
    mag = torch.maximum(k.abs(), plain.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return float(((k - plain).abs() / (ulp + RFF_ATOL)).max())


def k1_model(x16: torch.Tensor, om16: torch.Tensor, fold: int = K1_FOLD) -> torch.Tensor:
    """K1 on bf16 operands as featurize_bf16.cuh takes it."""
    z = bf16_product(om16.float(), x16.float().T.contiguous(), fold, split=False)
    inv = tkrff.inv_sqrt(om16.shape[0])
    return torch.cat([torch.cos(z) * inv, torch.sin(z) * inv]).bfloat16()


def _k1_operands(p, n, nf, seed, x_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(p, n)) * x_scale).astype(np.float32)
    om = rng.normal(size=(nf, p)).astype(np.float32)
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(om).bfloat16()


@pytest.mark.parametrize("p,n,nf", [(16, 64, 32), (33, 170, 77), (128, 128, 128), (7, 300, 130)])
def test_k1_model_holds_the_gate(p, n, nf):
    """K1 on bf16 X and Omega (tests/test_kernels.py:15's shapes, unit-scale
    operands: phases up to ~60): within one bf16 ULP plus 2e-5 of plain and of
    the reference's kernel (interpret mode)."""
    x16, om16 = _k1_operands(p, n, nf, seed=p * n)
    model = k1_model(x16, om16)
    assert _bf16_units(model, tkrff.rff_plain(x16, om16)) <= 1.0
    ref = jops.rff(jnp.asarray(x16.float().numpy(), jnp.bfloat16),
                   jnp.asarray(om16.float().numpy(), jnp.bfloat16), block=64)
    assert _bf16_units(model, torch.from_numpy(np.asarray(ref, np.float32))) <= 1.0


def test_k1_fold_bounds_the_truncation():
    """Why K1 folds every four stages: at p = 2048 on unit-scale X (phases
    up to ~200) one accumulator's truncations move outputs by more than a bf16
    ULP from plain; folding every 256 of k holds the gate, as it does at the
    smoke's scale."""
    x16, om16 = _k1_operands(2048, 300, 64, seed=2048 * 300)
    plain = tkrff.rff_plain(x16, om16)
    assert _bf16_units(k1_model(x16, om16, fold=0), plain) > 1.0
    assert _bf16_units(k1_model(x16, om16), plain) <= 1.0
    x16s, _ = _k1_operands(2048, 300, 64, seed=2048 * 300, x_scale=2048 ** -0.5)
    assert _bf16_units(k1_model(x16s, om16), tkrff.rff_plain(x16s, om16)) <= 1.0
