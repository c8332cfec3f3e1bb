"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (a CUDA kernel
has no CPU mode).  The file imports neither jax nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: Omega within 8 ULP and bits equal (K4); 2e-5 absolute on the
feature map (K1, K7, the latter also at the tensor-core tile's edges); atol
2e-5 on G_H / max|G_H| and on u (K2/K3, K5/K6, the latter also at those
edges and over many chunks); atol 1e-5 on G / max|G| (K8; on nearly
constant rows, or no farther from the float64 answer than plain where plain
itself misses that); the fit's eigenvalues to rtol 1e-2 and its
subspace to 1e-3; K10 bit for bit; K9 within 1e-5 * max(1, max|plain|) with
equal non-finite positions; the trainers' parameters, card against CPU, to
1e-4 (under qint8, where a bin flips between the devices: every entry
within one quantization step and 99 % within 1e-4); the async runtime's
histories, card against CPU, equal; K11 within 2e-5 at fp32 and one bf16
ULP of its plain output plus 2e-5 at bf16 (at most 3e-2), with equal
non-finite positions, at every head width (d 20 to 640, dv 12 to 288); a
two-layer LM's logits, card against CPU at fp32, to 1e-3 of max(1,
max|logit|); the materialized Omega equal to the CPU's bit for bit; a
serving dispatch one K1 launch, within 1e-5 of max|whole| of the transform;
telemetry on and off, and a probed and an unprobed round, bit for bit;
K11b's dq, dk, dv within 1e-4 x max(1, max|plain|) at fp32 and one bf16 ULP
of plain plus that at bf16 (plain: autograd of the plain forward on the
fp32 inputs, rounded once; also with v x 60 and on rows TMA takes only
padded), two launches bit for bit, the forward's lse within 2e-5; a train step,
card against CPU, within 1e-4 x max(1, max|leaf|) plus twice the step's
learning rate; the baselines' accuracies on the card equal to the CPU's
(TCA, CORAL, JDA) or within 0.02 (source-only); ``moe_forward`` and an MLA
block at their architectures' widths and fp32 within 1e-3 x max(1, max|x|)
of the CPU on the tokens routed alike (a token may route differently only at
a near-tie on the CPU: k-th and (k+1)-th probabilities within 1e-6); an
``LM.init`` on the card equal to the CPU's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import rf_tca as trf  # noqa: E402
from repro_torch.core.kernels_math import (  # noqa: E402
    assemble_streamed_gram_ensemble, ell_vector,
)
from repro_torch.core.rff import draw_omega  # noqa: E402
from repro_torch.data import make_domains  # noqa: E402
from repro_torch.federated import ClientConfig, FedRFTCATrainer, ProtocolConfig  # noqa: E402
from repro_torch.fleet import Topology  # noqa: E402
from repro_torch.kernels import centered_gram, ops, prng, quantize, ref, rff  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import segment_reduce  # noqa: E402
from repro_torch.kernels import rff_gram_stream as gram  # noqa: E402
from repro_torch.robust import FaultConfig  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    mag = torch.maximum(a.abs(), b.abs()).float()
    spacing = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).double()
    return float(((a - b).abs() / spacing).max())


def test_prng_kernel_matches_plain(card):
    kw = dict(row0=3, col0=2**32 - 100, ensemble_index=2, device=card)
    bits = prng.threefry_bits(2**33 + 5, 256, 300, **kw)
    plain = prng.threefry_bits_plain(2**33 + 5, 256, 300, **kw)
    assert torch.equal(bits[0], plain[0]) and torch.equal(bits[1], plain[1])
    for kind in ("gauss", "laplace"):
        for sigma in (1.0, 0.7):
            out = prng.fused_omega_block(9, 256, 300, sigma=sigma, rf_kernel=kind, **kw)
            exp = prng.fused_omega_block_plain(9, 256, 300, sigma=sigma, rf_kernel=kind, **kw)
            assert _ulps(out, exp) <= 8


@pytest.mark.parametrize("nf,p,n", [
    (96, 40, 300), (1000, 2048, 700),
    # a transform request's widths, split over p where the tiles are few
    *((nf, 2048, n) for nf in (1000, 4096) for n in (1, 64, 300, 512)),
    # Omega copied for TMA (p = 7); one k-tile short of a split; full width
    (65, 7, 795), (1000, 40, 795), (4096, 2048, 3612)])
def test_rff_kernel_matches_plain(card, nf, p, n):
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.normal(size=(p, n)) / np.sqrt(p)).astype(np.float32), device=card)
    om = torch.tensor(rng.normal(size=(nf, p)).astype(np.float32), device=card)
    out = rff.rff(x, om)
    assert (out - rff.rff_plain(x, om)).abs().max().item() <= 2e-5


def _sms(card) -> int:
    return torch.cuda.get_device_properties(card).multi_processor_count


@pytest.mark.parametrize("n", [300, 3612])
def test_rff_kernel_one_launch_split_or_not(card, n):
    """One rff.rff call counts one launch whether it splits p (a request's
    300 columns at N = 1000: 24 output tiles) or not (3612 columns); a split
    adds its slices in a fixed order, so two calls agree bit for bit."""
    rng = np.random.default_rng(n)
    x = torch.tensor((rng.normal(size=(2048, n)) / 45.0).astype(np.float32), device=card)
    om = torch.tensor(rng.normal(size=(1000, 2048)).astype(np.float32), device=card)
    slices = rff.split_plan(1000, 2048, n, sms=_sms(card))["slices"]
    assert (slices > 1) == (n == 300)
    before = rff.LAUNCHES["rff"]
    out = rff.rff(x, om)
    assert rff.LAUNCHES["rff"] == before + 1
    assert torch.equal(out, rff.rff(x, om))
    assert (out - rff.rff_plain(x, om)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nf,ensemble,sigma,kind", [
    (96, 1, 1.0, "gauss"), (300, 3, 0.8, "gauss"), (200, 2, 4.0, "laplace"),
])
def test_fused_gram_kernel_matches_plain(card, nf, ensemble, sigma, kind):
    rng = np.random.default_rng(nf)
    x = torch.tensor(rng.normal(size=(40, 700)).astype(np.float32), device=card)
    ell = ell_vector(350, 350, device=card)
    kw = dict(n_features=nf, seed=5, ensemble=ensemble)
    g_k, u_k = ops.rff_gram_stream_fused(x, ell, sigma_rf=sigma, rf_kernel=kind, **kw)
    g_p, u_p = ref.rff_gram_stream_fused_ref(x, ell, sigma=sigma, rf_kernel=kind, **kw)
    scale = g_p.abs().max()
    assert ((g_k - g_p).abs().max() / scale).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


def test_fused_gram_kernel_accumulates_over_chunks(card, monkeypatch):
    """A workspace of one featurize tile splits n = 700 into three chunks."""
    monkeypatch.setattr(gram, "WORKSPACE_BYTES", 1)
    plan = gram.gram_tile_plan(200, n=700, ensemble=2)
    assert plan["chunks"] == 3 and plan["block"] == gram.FEATURIZE_COLS
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(40, 700)).astype(np.float32), device=card)
    ell = ell_vector(400, 300, device=card)
    kw = dict(n_features=200, seed=7, ensemble=2)
    before = gram.LAUNCHES["accumulate"]
    g_k, u_k = ops.rff_gram_stream_fused(x, ell, sigma_rf=2.0, **kw)
    assert gram.LAUNCHES["accumulate"] - before == plan["chunks"]
    g_p, u_p = ref.rff_gram_stream_fused_ref(x, ell, sigma=2.0, **kw)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


def test_fit_and_transform_on_card_match_cpu(card):
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(12, 160)).astype(np.float32)
    xt = (rng.normal(size=(12, 120)) + 0.5).astype(np.float32)
    kw = dict(n_features=96, m=8, gamma=1e-2, sigma=3.0, w_rf="fused:2", ensemble=2)
    cpu = trf.rf_tca_fit(xs, xt, device="cpu", **kw)
    gpu = trf.rf_tca_fit(xs, xt, device=card, **kw)
    np.testing.assert_allclose(gpu.eigvals.cpu().numpy(), cpu.eigvals.numpy(), rtol=1e-2)
    q_c, _ = torch.linalg.qr(cpu.w_rf.double())
    q_g, _ = torch.linalg.qr(gpu.w_rf.double().cpu())
    assert torch.linalg.matrix_norm(q_c @ q_c.T - q_g @ q_g.T, ord=2).item() <= 1e-3
    f_c = trf.rf_tca_transform(cpu, xt)
    f_g = trf.rf_tca_transform(cpu._replace(w_rf=cpu.w_rf.to(card)), xt).cpu()
    assert ((f_g - f_c).abs().max() / f_c.abs().max()).item() <= 1e-4


def _operand(card, nf, p, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor((rng.normal(size=(p, n)) / np.sqrt(p)).astype(np.float32), device=card)
    om = torch.tensor(rng.normal(size=(nf, p)).astype(np.float32), device=card)
    return x, om, ell_vector(n // 2, n - n // 2, device=card)


@pytest.mark.parametrize("nf,p,n", [(96, 40, 300), (130, 7, 257), (77, 5, 97), (1000, 2048, 700),
                                    (65, 5, 795), (1000, 7, 795), (1000, 41, 700)])
def test_operand_gram_kernel_matches_plain(card, nf, p, n):
    """K2/K3: p = 5, 7, 41 are not multiples of the featurize k step nor of
    4 (Omega copied with zero columns for TMA), N = 65, 77, 130 not of a
    Gram tile, n ragged."""
    x, om, ell = _operand(card, nf, p, n, seed=nf + p)
    g_k, u_k = ops.rff_gram_stream(x, om, ell)
    g_p, u_p = ref.rff_gram_stream_ref(x, om, ell)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


def test_operand_gram_kernel_accumulates_over_chunks(card, monkeypatch):
    monkeypatch.setattr(gram, "WORKSPACE_BYTES", 1)
    plan = gram.gram_tile_plan(200, n=700)
    assert plan["chunks"] == 3
    x, om, ell = _operand(card, 200, 40, 700, seed=2)
    before = dict(gram.OPERAND_LAUNCHES)
    outs = gram.rff_gram_stream(x, om, ell)
    assert all(gram.OPERAND_LAUNCHES[k] - before[k] == 3 for k in before)
    for k_out, p_out in zip(outs, gram.rff_gram_stream_plain(x, om, ell)):
        assert ((k_out - p_out).abs().max() / p_out.abs().max()).item() <= 2e-5


@pytest.mark.parametrize("rows,n", [(64, 128), (130, 257), (32, 500), (2000, 3612), (130, 797),
                                    (2000, 3613), (64, 5)])
def test_centered_gram_kernel_matches_plain(card, rows, n):
    """K8: n = 257, 797, 3613 and 5 are not multiples of 4 (Sigma copied with
    zero columns for TMA) nor of the k-tile of 32 (padding masked after the
    shift); 130 and 2000 rows not of a 128-row tile."""
    rng = np.random.default_rng(rows)
    sig = torch.tensor(rng.normal(size=(rows, n)).astype(np.float32) + 0.3, device=card)
    before = centered_gram.LAUNCHES["centered_gram"]
    g_k = ops.centered_gram(sig)
    assert centered_gram.LAUNCHES["centered_gram"] == before + 1
    g_p = centered_gram.centered_gram_plain(sig)
    assert torch.equal(g_k, g_k.T)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("nf,n", [(65, 795), (1000, 795), (65, 3612)])
def test_centered_gram_kernel_nearly_constant_rows(card, nf, n):
    """Sigma from K1 at sigma 28 on 7 rows: phases under ~0.2, rows of cos
    nearly constant, so G is a cancellation that a one-sided shift or an
    unmasked pad would miss.  Within 1e-5 of plain, or no farther from the
    float64 answer than plain where plain itself is past 1e-5 of it."""
    rng = np.random.default_rng(nf + n)
    x = torch.tensor((0.44 * rng.normal(size=(7, n))).astype(np.float32), device=card)
    om = torch.tensor((rng.normal(size=(nf, 7)) / 28.0).astype(np.float32), device=card)
    sig = rff.rff(x, om)
    g_k = centered_gram.centered_gram(sig)
    g_p = centered_gram.centered_gram_plain(sig)
    err = ((g_k - g_p).abs().max() / g_p.abs().max()).item()
    if err > 1e-5:
        g_x = centered_gram.centered_gram_plain(sig.double())
        dist = [((g.double() - g_x).abs().max() / g_x.abs().max()).item() for g in (g_k, g_p)]
        assert dist[1] > 1e-5 and dist[0] <= dist[1]


@pytest.mark.parametrize("nf,p,n,e,sigma,kind", [
    (32, 16, 64, 0, 1.3, "gauss"), (96, 7, 130, 1, 1.3, "gauss"), (300, 40, 517, 2, 4.0, "laplace"),
])
def test_rff_fused_kernel_matches_plain(card, nf, p, n, e, sigma, kind):
    """K7 against its plain version.  Cauchy phases are heavy-tailed, and at a
    phase of 1e4 one ULP of the product is a feature error of 1e-3 / sqrt(N),
    so the laplace case keeps its phases moderate, as the reference's own
    laplace tests do (0.3 x, tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(p, n)) / np.sqrt(p)).astype(np.float32)
    x = torch.tensor(0.3 * x if kind == "laplace" else x, device=card)
    kw = dict(n_features=nf, seed=2**32 + 9, ensemble_index=e, sigma=sigma, rf_kernel=kind)
    out = rff.rff_fused(x, **kw)
    assert (out - rff.rff_fused_plain(x, **kw)).abs().max().item() <= 2e-5


# the tensor-core featurize's edges: N past a 128-feature block (65, 1000),
# p under and over a k-tile of 32 (7, 40, 2048), n = 1, ragged (795, copied
# to a multiple of 4 for TMA) and whole 256-column tiles (512, 1024)
FUSED_EDGES = [(65, 7, 1), (65, 40, 795), (1000, 2048, 512), (1000, 40, 795),
               (65, 2048, 1024), (1000, 7, 1)]


@pytest.mark.parametrize("nf,p,n", FUSED_EDGES)
def test_rff_fused_kernel_tile_edges(card, nf, p, n):
    rng = np.random.default_rng(nf + p + n)
    x = torch.tensor((rng.normal(size=(p, n)) / np.sqrt(p)).astype(np.float32), device=card)
    kw = dict(n_features=nf, seed=3, ensemble_index=1, sigma=0.9)
    before = rff.LAUNCHES["rff_fused"]
    out = rff.rff_fused(x, **kw)
    assert rff.LAUNCHES["rff_fused"] == before + 1
    assert (out - rff.rff_fused_plain(x, **kw)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nf,p,n", [e for e in FUSED_EDGES if e[2] > 1])
@pytest.mark.parametrize("ensemble", [1, 4])
def test_fused_gram_kernel_tile_edges(card, nf, p, n, ensemble):
    rng = np.random.default_rng(nf * ensemble + n)
    x = torch.tensor((rng.normal(size=(p, n)) / np.sqrt(p)).astype(np.float32), device=card)
    ell = ell_vector(n // 2, n - n // 2, device=card)
    kw = dict(n_features=nf, seed=4, ensemble=ensemble, sigma=0.9)
    g_k, u_k = assemble_streamed_gram_ensemble(
        *gram.rff_gram_stream_fused(x, ell, **kw), n=n, ensemble=ensemble)
    g_p, u_p = assemble_streamed_gram_ensemble(
        *gram.rff_gram_stream_fused_plain(x, ell, **kw), n=n, ensemble=ensemble)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


def test_fused_gram_kernel_many_chunks(card, monkeypatch):
    """A workspace of one featurize tile: n = 3612 at N = 1000, S = 4 in 15
    chunks of 256 columns, each with its own Omega draws and k split."""
    monkeypatch.setattr(gram, "WORKSPACE_BYTES", 1)
    plan = gram.gram_tile_plan(1000, n=3612, ensemble=4)
    assert plan["chunks"] == 15
    rng = np.random.default_rng(11)
    x = torch.tensor((rng.normal(size=(40, 3612)) / np.sqrt(40)).astype(np.float32), device=card)
    ell = ell_vector(2817, 795, device=card)
    kw = dict(n_features=1000, seed=6, ensemble=4, sigma=0.9)
    before = dict(gram.LAUNCHES)
    g_k, u_k = assemble_streamed_gram_ensemble(*gram.rff_gram_stream_fused(x, ell, **kw),
                                               n=3612, ensemble=4)
    assert all(gram.LAUNCHES[k] - before[k] == 15 for k in before)
    g_p, u_p = assemble_streamed_gram_ensemble(*gram.rff_gram_stream_fused_plain(x, ell, **kw),
                                               n=3612, ensemble=4)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


@pytest.mark.parametrize("n", [1, 795, 1024, 3612])
def test_rff_fused_kernel_counts_its_draws(card, n):
    """The kernel's own count: each Omega element drawn at most once per 1024
    sample columns, and no phase of Gaussian draws at unit scale recomputed."""
    rng = np.random.default_rng(n)
    x = torch.tensor((rng.normal(size=(40, n)) / np.sqrt(40)).astype(np.float32), device=card)
    kw = dict(n_features=300, seed=8, ensemble_index=2, sigma=0.9)
    cnt = torch.zeros(3, dtype=torch.int64, device=card)
    out = rff.rff_fused(x, counters=cnt, **kw)
    drawn, recomputed, redrawn = cnt.tolist()
    assert 300 * 40 <= drawn <= 300 * 40 * -(-n // 1024) and drawn % (300 * 40) == 0
    assert recomputed == redrawn == 0
    assert (out - rff.rff_fused_plain(x, **kw)).abs().max().item() <= 2e-5


def test_fused_featurize_counts_recomputed_phases(card):
    """Cauchy draws on unscaled X (the laplace Gram case above): phases of
    |z| >= 64 are recomputed as fp32's FMA chain, in every chunk; the
    result holds the Gram gate."""
    rng = np.random.default_rng(200)
    x = torch.tensor(rng.normal(size=(40, 700)).astype(np.float32), device=card)
    ell = ell_vector(350, 350, device=card)
    kw = dict(n_features=200, seed=5, ensemble=2, sigma=4.0, rf_kernel="laplace")
    cnt = torch.zeros(3, dtype=torch.int64, device=card)
    g_k, u_k = assemble_streamed_gram_ensemble(
        *gram.rff_gram_stream_fused(x, ell, counters=cnt, **kw), n=700, ensemble=2)
    drawn, recomputed, redrawn = cnt.tolist()
    om = [prng.fused_omega_block_plain(5, 200, 40, ensemble_index=e, sigma=4.0,
                                       rf_kernel="laplace", device=card) for e in range(2)]
    big = sum(int(((o @ x).abs() >= 64).sum()) for o in om)
    assert abs(recomputed - big) <= big // 100 and redrawn % 40 == 0 < redrawn
    assert drawn % (200 * 40 * 2) == 0 < drawn
    g_p, u_p = assemble_streamed_gram_ensemble(
        *gram.rff_gram_stream_fused_plain(x, ell, **kw), n=700, ensemble=2)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nf,p,n", [(200, 40, 700), (1000, 7, 795)])
def test_operand_featurize_recomputes_large_phases(card, nf, p, n):
    """K2/K3 with a Cauchy Omega operand (``draw_omega``'s laplace) on
    unscaled X: phases of |z| >= 64 are recomputed as fp32's FMA chain from
    the operand (p = 7: its padded copy), counted by the kernel (nothing is
    drawn); the result holds the Gram gate."""
    rng = np.random.default_rng(nf + p)
    x = torch.tensor(rng.normal(size=(p, n)).astype(np.float32), device=card)
    om = draw_omega(5, nf, p, sigma=4.0, kernel="laplace", device=card)
    ell = ell_vector(n // 2, n - n // 2, device=card)
    cnt = torch.zeros(3, dtype=torch.int64, device=card)
    g_k, u_k = assemble_streamed_gram_ensemble(*gram.rff_gram_stream(x, om, ell, counters=cnt),
                                               n=n, ensemble=1)
    drawn, recomputed, redrawn = cnt.tolist()
    big = int(((om @ x).abs() >= 64).sum())
    assert drawn == redrawn == 0 < big and abs(recomputed - big) <= big // 100
    g_p, u_p = assemble_streamed_gram_ensemble(*gram.rff_gram_stream_plain(x, om, ell), n=n,
                                               ensemble=1)
    assert ((g_k - g_p).abs().max() / g_p.abs().max()).item() <= 2e-5
    assert (u_k - u_p).abs().max().item() <= 2e-5


# a shape that K1 splits over p (32 output tiles, 8 k-tiles: 2 slices)
SPLIT_CAUCHY = (200, 256, 2048)


@pytest.mark.parametrize("nf,p,n", [(200, 40, 700), SPLIT_CAUCHY])
def test_rff_kernel_recomputes_large_phases(card, monkeypatch, nf, p, n):
    """K1 with a Cauchy Omega (``draw_omega``'s laplace) on unscaled X, one
    launch into Sigma (p = 40) and split over p: phases of |z| >= 64 are
    recomputed as fp32's FMA chain (in the epilogue, or from the whole sum
    in the finishing pass), counted by the kernel (nothing is drawn), and
    hold 2e-5 against plain there.  Elsewhere the map holds 2e-5 plus the
    split products' rounding, 2^-20 of sum_k |omega_k x_k| (times 1/sqrt(N)):
    a phase under 64 summed from terms of ~1e4 is as far from plain in the
    split products as 2^-20 of those terms, one launch or split
    (tests/test_torch_split_tf32_numerics.py models it; chip_smoke.py's K1
    laplace check counts such elements).  The split run agrees with a
    one-launch run of the same call within 2e-5."""
    rng = np.random.default_rng(nf + p)
    x = torch.tensor(rng.normal(size=(p, n)).astype(np.float32), device=card)
    om = draw_omega(5, nf, p, sigma=4.0, kernel="laplace", device=card)
    assert (rff.split_plan(nf, p, n, sms=_sms(card))["slices"] > 1) == (p > 40)
    cnt = torch.zeros(3, dtype=torch.int64, device=card)
    out = rff.rff(x, om, counters=cnt)
    drawn, recomputed, redrawn = cnt.tolist()
    z = om @ x
    big = z.abs() >= 64
    assert drawn == redrawn == 0 < int(big.sum())
    assert abs(recomputed - int(big.sum())) <= int(big.sum()) // 100
    diff = (out - rff.rff_plain(x, om)).abs()
    assert diff[torch.cat([big, big])].max().item() <= 2e-5
    terms = (om.abs() @ x.abs()) * rff.inv_sqrt(nf) * 2.0 ** -20
    assert bool((diff <= 2e-5 + torch.cat([terms, terms])).all())
    monkeypatch.setattr(rff, "split_plan", lambda nf, p, n, *, sms: dict(
        slices=1, kt_per_split=-(-p // rff.K_TILE)))
    assert (out - rff.rff(x, om)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nf,ensemble,p,n", [(65, 1, 40, 795), (96, 2, 16, 600)])
def test_fused_gram_kernel_small_phases(card, nf, ensemble, p, n):
    """Phases under ~0.2 (sigma 28): every row of C is nearly constant and
    G_H is a cancellation of G_cc.  The kernel is held to be no farther from
    the float64 answer (from the same Omega draws) than plain."""
    rng = np.random.default_rng(nf + p)
    x = torch.tensor((0.44 * rng.normal(size=(p, n))).astype(np.float32), device=card)
    ell = ell_vector(n // 2, n - n // 2, device=card)
    kw = dict(n_features=nf, seed=3, ensemble=ensemble, sigma=28.0)
    g_k, _ = assemble_streamed_gram_ensemble(*gram.rff_gram_stream_fused(x, ell, **kw), n=n,
                                             ensemble=ensemble)
    g_p, _ = assemble_streamed_gram_ensemble(*gram.rff_gram_stream_fused_plain(x, ell, **kw),
                                             n=n, ensemble=ensemble)
    scale = gram.feature_scale(nf, ensemble)
    cs, ss = [], []
    for e in range(ensemble):
        om = prng.fused_omega_block_plain(3, nf, p, ensemble_index=e, sigma=28.0, device=card)
        z = om.double() @ x.double()
        cs.append(torch.cos(z) * scale)
        ss.append(torch.sin(z) * scale)
    mom = [torch.stack([m for b in blocks for m in (b @ ell.double(), b.sum(dim=1))], dim=1)
           for blocks in (cs, ss)]
    c, s = torch.cat(cs, dim=1), torch.cat(ss, dim=1)
    g_x, _ = assemble_streamed_gram_ensemble(c @ c.T, c @ s.T, s @ s.T, *mom, n=n,
                                             ensemble=ensemble)
    err = [float((g.double() - g_x).abs().max() / g_x.abs().max()) for g in (g_k, g_p)]
    assert err[0] <= err[1]


def test_operand_and_fused_paths_keep_their_kernels(card, monkeypatch):
    """Each path keeps its featurize (Omega loaded for K2/K3, drawn for
    K5/K6); both run the one tensor-core Gram accumulate."""
    fetched = []
    fn = gram._build.fn

    def recording(lib, sym, argtypes):
        fetched.append(sym)
        return fn(lib, sym, argtypes)

    monkeypatch.setattr(gram._build, "fn", recording)
    x, om, ell = _operand(card, 96, 40, 300, seed=1)
    gram.rff_gram_stream(x, om, ell)
    assert {"rt_operand_featurize", "rt_fused_gram_accumulate"} <= set(fetched)
    assert "rt_fused_featurize" not in fetched and "rt_gram_accumulate" not in fetched
    fetched.clear()
    gram.rff_gram_stream_fused(x, ell, n_features=96, seed=1)
    assert {"rt_fused_featurize", "rt_fused_gram_accumulate"} <= set(fetched)
    assert "rt_operand_featurize" not in fetched and "rt_gram_accumulate" not in fetched


@pytest.mark.parametrize("mode,solver", [("stream", "eigh"), ("stream", "lobpcg"),
                                         ("dense", "eigh"), ("dense", "cholesky")])
def test_omega_fit_on_card_matches_cpu(card, mode, solver):
    """The w_rf=None fits (K2/K3, or K1 + K8) on the card against the plain
    path on the CPU; ``draw_omega`` gives both one Omega.  LOBPCG's subspace
    is held to the reference's LOBPCG bound."""
    rng = np.random.default_rng(8)
    xs = rng.normal(size=(12, 160)).astype(np.float32)
    xt = (rng.normal(size=(12, 120)) + 0.5).astype(np.float32)
    kw = dict(n_features=96, m=8, gamma=1e-2, sigma=3.0, seed=3, mode=mode, solver=solver)
    cpu = trf.rf_tca_fit(xs, xt, device="cpu", **kw)
    gpu = trf.rf_tca_fit(xs, xt, device=card, **kw)
    assert torch.equal(gpu.omega.cpu(), cpu.omega)
    np.testing.assert_allclose(gpu.eigvals.cpu().numpy(), cpu.eigvals.numpy(), rtol=1e-2)
    q_c, _ = torch.linalg.qr(cpu.w_rf.double())
    q_g, _ = torch.linalg.qr(gpu.w_rf.double().cpu())
    if solver == "lobpcg":  # stops at a residual, not at convergence to rounding
        assert torch.linalg.svdvals(q_c.T @ q_g).min().item() > 1 - 1e-3  # test_streaming_solver:70
    else:
        assert torch.linalg.matrix_norm(q_c @ q_c.T - q_g @ q_g.T, ord=2).item() <= 1e-3


@pytest.mark.parametrize("kernel", ["gauss", "laplace"])
@pytest.mark.parametrize("nf,p,sigma", [(96, 40, 3.0), (4096, 2048, 0.7)])
def test_draw_omega_on_card_equals_cpu(card, kernel, nf, p, sigma):
    """The materialized Omega is one draw on every device, bit for bit."""
    om = draw_omega(11, nf, p, sigma=sigma, kernel=kernel, device=card)
    assert om.device.type == "cuda"
    assert torch.equal(om.cpu(), draw_omega(11, nf, p, sigma=sigma, kernel=kernel, device="cpu"))


def _served_pair(card, capacity=2, **server_kw):
    from repro_torch.serve import AlignerServer

    rng = np.random.default_rng(21)
    xs = rng.normal(size=(64, 300)).astype(np.float32)
    xt = (rng.normal(size=(64, 200)) + 0.5).astype(np.float32)
    srv = AlignerServer(capacity=capacity, min_bucket=8, max_bucket=256, device=card,
                        **server_kw)
    srv.fit_domain(("s", "t"), xs, xt, n_features=500, m=16, gamma=1e-2, sigma=8.0)
    return srv, rng


def test_dispatch_launches_k1_once_and_matches_transform(card):
    """One serving dispatch of a burst: one K1 launch, outputs within 1e-5 of
    max|whole| of one rf_tca_transform of the same columns."""
    from repro_torch.serve import Request

    srv, rng = _served_pair(card)
    reqs = [Request(x=rng.normal(size=(64, n)).astype(np.float32), key=("s", "t"))
            for n in (3, 64, 17, 100)]
    srv.warmup(("s", "t"))
    before, d0 = rff.LAUNCHES["rff"], srv.dispatcher.dispatches
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    assert srv.dispatcher.dispatches - d0 == 1 and rff.LAUNCHES["rff"] - before == 1
    state = srv.store.get(("s", "t")).state
    whole = trf.rf_tca_transform(state, np.concatenate([r.x for r in reqs], axis=1)).cpu()
    got = torch.from_numpy(np.concatenate([o for _, o in done], axis=1))
    assert float((got - whole).abs().max() / whole.abs().max()) <= 1e-5


def test_serving_telemetry_off_and_on_bit_for_bit(card):
    """Telemetry on (request tracer, SLO engine, the drift monitor's probed
    planes, a registry and a tracer) serves the same bits as off."""
    from repro_torch import obs
    from repro_torch.serve import synth_requests

    off, _ = _served_pair(card, sentinel_prefix="cuda.off")
    on, _ = _served_pair(card, sentinel_prefix="cuda.on")
    on.store.put(("s", "t"), off.store.get(("s", "t")))  # one state behind both
    on.attach(request_tracer=obs.RequestTracer(rate=1.0),
              slo=obs.SloEngine([obs.Slo("serve.latency", target=0.9, bound=10.0,
                                         window_fast_s=0.05, window_slow_s=0.5)]),
              drift=obs.DriftMonitor(window=2, threshold=1e9))
    reqs = synth_requests([("s", "t")], dim=64, n_requests=12, seed=3, cols_lo=4, cols_hi=120)
    plain = [o for _, o in off.serve(reqs)]
    with obs.use_registry(obs.MetricsRegistry()), obs.use_tracer(obs.Tracer()):
        wired = [o for _, o in on.serve(reqs)]
    assert on.drift.history and all(np.array_equal(a, b) for a, b in zip(plain, wired))


def test_probed_round_on_card_is_bit_for_bit_unprobed(card):
    from repro_torch.comm.netsim import TraceScenario
    from repro_torch.federated import RoundPlan
    from repro_torch.obs import sentinel

    doms = make_domains(4, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    cfg = ClientConfig(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8))
    full = TraceScenario([RoundPlan([0, 1, 2], [0, 1, 2], [0, 1, 2])], cycle=True)
    kw = dict(n_rounds=4, t_c=2, warmup_rounds=2, batch_size=32, seed=0, scenario=full)
    off = FedRFTCATrainer(doms[:3], doms[3], cfg, ProtocolConfig(**kw), device=card)
    on = FedRFTCATrainer(doms[:3], doms[3], cfg, ProtocolConfig(probe=True, **kw), device=card)
    off.train()
    before = sentinel.counts()
    on.train()
    sentinel.assert_stable(before, ("engine.round",), expect=1)
    for a, b in zip(tree_leaves((off.tgt_params, off._src_stack)),
                    tree_leaves((on.tgt_params, on._src_stack))):
        assert torch.equal(a, b)
    probes = on.last_probes
    assert float(probes["moment_mass"]) == 3.0 and np.isfinite(probes["update_norm"]).all()


@pytest.mark.parametrize("rows,d", [(1, 1024), (4, 1024), (65, 32768), (4, 160), (7, 13),
                                    (3, 1), (2, 4097)])
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_kernel_matches_plain(card, rows, d, bits):
    """K10: bit for bit, vector (d % 4 == 0) and scalar rows, zero rows included."""
    g = torch.Generator(device=card).manual_seed(rows * d + bits)
    x = torch.randn((rows, d), generator=g, device=card) * 3.0
    x[0, : min(d, 5)] = 0.0
    if rows > 2:
        x[2] = 0.0  # an all-zero payload quantizes through scale 1
    u = torch.rand((rows, d), generator=g, device=card)
    qmax = quantize.qmax_of(bits)
    scale = quantize.quant_scale(x, qmax)
    before = quantize.LAUNCHES["fake_quant"]
    out = quantize.fake_quant(x, u, scale, qmax=qmax)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES["fake_quant"] == before + 1
    assert torch.equal(out, quantize.fake_quant_plain(x, u, scale, qmax=qmax))
    assert torch.equal(out.cpu(), quantize.fake_quant_plain(x.cpu(), u.cpu(), scale.cpu(),
                                                            qmax=qmax))


def test_fake_quant_kernel_keeps_nan_and_raises_on_mixed_devices(card):
    x = torch.tensor([[1.0, float("nan"), -2.0, 0.5]], device=card)
    u = torch.full_like(x, 0.25)
    scale = torch.tensor([0.5], device=card)
    out = quantize.fake_quant(x, u, scale, qmax=7)
    assert torch.equal(out.isnan(), quantize.fake_quant_plain(x, u, scale, qmax=7).isnan())
    with pytest.raises(ValueError):
        quantize.fake_quant(x, u.cpu(), scale, qmax=7)


@pytest.mark.parametrize("engine", ["batched", "serial"])
def test_trainer_on_card_matches_cpu(card, engine):
    """The trainer's main path on the card: with qint8 over the wire the
    batched engine launches K10; parameters agree with the CPU run to 1e-4
    (the channel's uniforms come from each device's generator, so a lossy
    codec is compared through its byte log and accuracy range only)."""
    doms = make_domains(4, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    cfg = ClientConfig(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
                       rff_impl="fused")
    kw = dict(engine=engine, n_rounds=4, t_c=2, warmup_rounds=2, batch_size=32, seed=0)
    runs = {}
    for dev in ("cpu", card):
        tr = FedRFTCATrainer(doms[:3], doms[3], cfg, ProtocolConfig(**kw), device=dev)
        tr.train()
        runs[str(dev)] = tr
    a, b = runs["cpu"], runs[str(card)]
    for x, y in zip(tree_leaves(a.tgt_params), tree_leaves(b.tgt_params)):
        assert (x - y.cpu()).abs().max().item() < 1e-4
    before = quantize.LAUNCHES["fake_quant"]
    tr = FedRFTCATrainer(doms[:3], doms[3], cfg, ProtocolConfig(
        transport="wire", codec="qint8", **kw), device=card)
    tr.train()
    torch.cuda.synchronize()
    launched = quantize.LAUNCHES["fake_quant"] - before
    assert (launched > 0) == (engine == "batched")
    assert 0.0 <= tr.evaluate() <= 1.0


# the hierarchy's launch shapes at chip_smoke's FL and FS (a ones column makes
# D odd) and the reference test's ragged shapes (tests/test_fleet.py:85)
K9_SHAPES = [(1024, 1025, 64), (1024, 32769, 64), (1024, 161, 64), (1024, 6, 64), (4, 1025, 2),
             (4, 161, 4), (8, 16, 3), (130, 70, 5), (1, 5, 1), (1024, 300, 1024)]


@pytest.mark.parametrize("k,d,e", K9_SHAPES)
def test_segment_reduce_kernel_matches_plain(card, k, d, e):
    """K9: within 1e-5 * max(1, max|plain|); zero weights give exact zeros."""
    g = torch.Generator(device=card).manual_seed(k + d + e)
    v = torch.randn((k, d), generator=g, device=card)
    seg = torch.randint(0, e, (k,), generator=g, device=card, dtype=torch.int32)
    w = torch.rand((k,), generator=g, device=card)
    before = segment_reduce.LAUNCHES["segment_reduce"]
    out = ops.segment_reduce(v, seg, w, n_segments=e)
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] == before + 1
    plain = segment_reduce.segment_reduce_plain(v, seg, w, e)
    tol = 1e-5 * max(1.0, plain.abs().max().item())
    assert out.shape == (e, d) and (out - plain).abs().max().item() <= tol
    zero = ops.segment_reduce(v, seg, torch.zeros_like(w), n_segments=e)
    assert zero.abs().max().item() == 0.0


def test_segment_reduce_kernel_spreads_non_finite_values_like_plain(card):
    """A non-finite value in column d of any row makes column d NaN in every
    other edge, as the dense weighted-membership product does."""
    v = torch.tensor([[1, 2, 3], [float("nan"), 5, 6], [7, 8, float("inf")], [1, 2, 3]],
                     device=card)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=card)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0], device=card)
    out = ops.segment_reduce(v, seg, w, n_segments=2).cpu()
    want = torch.tensor([[float("nan"), 2, float("nan")], [float("nan"), 10, float("inf")]])
    assert torch.equal(out.isnan(), want.isnan()) and torch.equal(out.isinf(), want.isinf())
    g = torch.Generator(device=card).manual_seed(3)
    v = torch.randn((1024, 1025), generator=g, device=card)
    v[3, 5], v[77, 5], v[12, 900], v[100, 40] = float("nan"), float("inf"), -float("inf"), 1e38
    w = torch.rand((1024,), generator=g, device=card)
    seg = torch.arange(1024, device=card, dtype=torch.int32) // 16
    small = torch.randn((6, 4), generator=g, device=card)
    small[2, 1] = 0.0  # inf * 0 = NaN inside the edge
    w_inf = torch.tensor([1.0, 0.0, float("inf"), 1.0, 1.0, 0.5], device=card)
    seg_small = torch.tensor([0, 1, 1, 2, 2, 0], dtype=torch.int32, device=card)
    for args in ((v, seg, w, 64), (small, seg_small, w_inf, 3)):
        out = ops.segment_reduce(*args[:3], n_segments=args[3])
        plain = segment_reduce.segment_reduce_plain(*args)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(out), test(plain))
        ok = torch.isfinite(plain)
        if ok.any():
            err = (out[ok] - plain[ok]).abs().max().item()
            assert err <= 1e-5 * max(1.0, plain[ok].abs().max().item())
    with pytest.raises(ValueError):
        ops.segment_reduce(v, seg.cpu(), w, n_segments=64)


def test_two_tier_trainer_on_card_matches_cpu(card):
    """chip_smoke's FS at a test's width: grouped edges, client_chunk=2,
    trimmed mean under a Byzantine scale attack; K9 launches on the card."""
    doms = make_domains(5, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    cfg = ClientConfig(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
                       rff_impl="fused")
    kw = dict(n_rounds=4, t_c=2, warmup_rounds=2, batch_size=32, seed=0,
              topology=Topology.of_groups([[0, 1], [2, 3]]), client_chunk=2,
              rule="trimmed_mean",
              faults=FaultConfig(byzantine=(0,), byzantine_mode="scale", byzantine_scale=100.0))
    before = segment_reduce.LAUNCHES["segment_reduce"]
    runs = {}
    for dev in ("cpu", card):
        tr = FedRFTCATrainer(doms[:4], doms[4], cfg, ProtocolConfig(**kw), device=dev)
        tr.train()
        runs[str(dev)] = tr
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] > before
    a, b = runs["cpu"], runs[str(card)]
    for x, y in zip(tree_leaves((a.tgt_params, a._src_stack)),
                    tree_leaves((b.tgt_params, b._src_stack))):
        assert (x - y.cpu()).abs().max().item() < 1e-4


def _async_run(dev, kw, acfg, *, cpu_uniforms=False, edge_links=None):
    """An ``AsyncScheduler`` run at a test's width on ``dev``: churn and
    heterogeneous links; with ``cpu_uniforms`` the channel draws the CPU
    generator's uniforms (the card's generator draws other numbers)."""
    from types import SimpleNamespace

    from repro_torch.comm.netsim import LinkModel, LinkScenario
    from repro_torch.federated.engine import BatchedRoundEngine
    from repro_torch.fedsim import AsyncScheduler, markov_trace

    doms = make_domains(5, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    cfg = ClientConfig(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
                       rff_impl="fused")
    tr = FedRFTCATrainer(doms[:4], doms[4], cfg, ProtocolConfig(**kw), device=dev)
    if cpu_uniforms and tr._engine.channel:
        shim = SimpleNamespace(channel_seed=tr._engine.channel_seed, device=torch.device("cpu"))
        tr._engine.channel_uniforms = lambda *a: BatchedRoundEngine.channel_uniforms(
            shim, *a).to(dev)
    links = LinkScenario(links=[LinkModel(latency_s=0.3 * (i + 1), jitter_s=0.2, drop=0.1)
                                for i in range(4)])
    avail = markov_trace(4, 4000.0, mean_on=12.0, mean_off=3.0, seed=5)
    sched = AsyncScheduler(tr, acfg, availability=avail, links=links, edge_links=edge_links)
    hist = sched.run(8, eval_every=4)
    return tr, [{k: v for k, v in h.to_dict().items() if k != "acc"} for h in hist]


def _close_or_one_bin(a_tree, b_tree):
    """Within 1e-4 of max(1, max|leaf|); where a qint8 bin flipped between
    the devices, every entry within one quantization step (max|leaf| / 127)
    and 99 % within 1e-4 (tests/test_torch_federated.py's qint8 rule)."""
    within = total = 0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        d = (a.cpu() - b.cpu()).abs()
        scale = max(1.0, b.abs().max().item())
        assert d.max().item() <= max(b.abs().max().item() / 127, 1e-4 * scale)
        within += int((d <= 1e-4 * scale).sum())
        total += d.numel()
    assert within >= 0.99 * total


def test_async_scheduler_on_card_matches_cpu(card):
    """The async runtime's flush on the card (flat, identity): the CPU's
    history and parameters within 1e-4."""
    from repro_torch.fedsim import AsyncConfig

    kw = dict(n_rounds=0, t_c=4, warmup_rounds=2, batch_size=32, seed=0)
    acfg = AsyncConfig(buffer_size=2, staleness="polynomial", eval_interval=3.0)
    cpu, h_cpu = _async_run("cpu", kw, acfg)
    gpu, h_gpu = _async_run(card, kw, acfg)
    assert h_gpu == h_cpu
    for x, y in zip(tree_leaves((cpu.tgt_params, cpu._src_stack)),
                    tree_leaves((gpu.tgt_params, gpu._src_stack))):
        assert (x - y.cpu()).abs().max().item() < 1e-4


def test_async_fleet_flush_on_card_launches_k9_and_k10(card):
    """Per-edge buffers over edge links, qint8 on both tiers, client_chunk 2:
    the flush launches K9 and K10 on the card; the history equals the CPU's
    and the parameters agree as ``_close_or_one_bin`` says."""
    from repro_torch.comm.netsim import LinkModel, LinkScenario
    from repro_torch.fedsim import AsyncConfig

    kw = dict(n_rounds=0, t_c=2, warmup_rounds=2, batch_size=32, seed=0, transport="wire",
              codec="qint8", edge_codec="qint8", topology=Topology.of_groups([[0, 1], [2, 3]]),
              client_chunk=2)
    acfg = AsyncConfig(buffer_size=2, staleness="polynomial")
    edges = LinkScenario(links=[LinkModel(latency_s=0.7), LinkModel(latency_s=0.2)])
    cpu, h_cpu = _async_run("cpu", kw, acfg, edge_links=edges)
    k9, k10 = segment_reduce.LAUNCHES["segment_reduce"], quantize.LAUNCHES["fake_quant"]
    gpu, h_gpu = _async_run(card, kw, acfg, cpu_uniforms=True, edge_links=edges)
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] > k9
    assert quantize.LAUNCHES["fake_quant"] > k10
    assert h_gpu == h_cpu
    _close_or_one_bin((gpu.tgt_params, gpu._src_stack), (cpu.tgt_params, cpu._src_stack))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


K11_SHAPES = [(1, 2, 1, 128, 32, 32), (2, 4, 2, 128, 16, 16), (1, 4, 4, 256, 32, 16),
              (2, 8, 2, 64, 64, 64), (2, 9, 3, 77, 64, 64), (1, 2, 1, 1, 64, 64),
              (1, 4, 2, 300, 128, 128), (1, 2, 2, 130, 112, 112),
              # MLA's d 192 / dv 128; d past one fp32 chunk and dv split over the
              # grid; rows of 40 bytes (no TMA: padded by the wrapper); d streamed
              # through the bf16 ring
              (1, 4, 4, 256, 192, 128), (1, 2, 1, 100, 320, 288), (1, 2, 1, 100, 20, 12),
              (1, 2, 1, 200, 640, 64)]


@pytest.mark.parametrize("b,h,kv,s,d,dv", K11_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0), (False, 48)])
def test_flash_attention_kernel_matches_plain(card, b, h, kv, s, d, dv, dtype, causal, window):
    g = torch.Generator(device=card).manual_seed(b * h * s + d)
    q = torch.randn((b, h, s, d), generator=g, device=card).to(dtype)
    k = torch.randn((b, kv, s, d), generator=g, device=card).to(dtype)
    v = torch.randn((b, kv, s, dv), generator=g, device=card).to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (b, h, s, dv)
    assert torch.equal(torch.isfinite(out), torch.isfinite(plain))
    err = (out.float() - plain.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        # one bf16 ULP of plain, plus the fp32 atol: near zero an output is a
        # sum with cancellation, whose fp32 error outgrows the result's ULP
        assert bool((err <= _bf16_ulp(plain) + 2e-5).all()) and err.max().item() <= 3e-2


@pytest.mark.parametrize("b,h,kv,s,d,dv", [(2, 4, 2, 512, 64, 64), (1, 4, 2, 256, 128, 128)])
def test_flash_attention_bf16_model_scale_v_within_gate(card, b, h, kv, s, d, dv):
    """v at a model's scale (x 60, as in smollm-135m's prefill): outputs that
    cancel are held to ~2e-5, which p in three bf16 parts meets (two parts
    leave ~2^-17 |v|; tests/test_torch_flash_numerics.py)."""
    g = torch.Generator(device=card).manual_seed(b * h * s + d)
    q = torch.randn((b, h, s, d), generator=g, device=card).bfloat16()
    k = torch.randn((b, kv, s, d), generator=g, device=card).bfloat16()
    v = (torch.randn((b, kv, s, dv), generator=g, device=card) * 60).bfloat16()
    out = ops.flash_attention(q, k, v)
    plain = fa.flash_attention_plain(q, k, v)
    err = (out.float() - plain.float()).abs()
    assert bool((err <= _bf16_ulp(plain) + 2e-5).all())
    assert err.max().item() <= 3e-2 * max(1.0, plain.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_strides_and_raises(card, dtype):
    """The model's (b, s, h, d) activations go in as transposed views; the
    output comes back in q's memory order."""
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 100, 6, 64), generator=g, device=card).to(dtype)
    k = torch.randn((2, 100, 2, 64), generator=g, device=card).to(dtype)
    v = torch.randn((2, 100, 2, 64), generator=g, device=card).to(dtype)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    plain = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert out.transpose(1, 2).is_contiguous()
    err = (out.float() - plain.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert bool((err <= _bf16_ulp(plain) + 2e-5).all())
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2).cpu(), v.transpose(1, 2))
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2).half(), k.transpose(1, 2).half(),
                            v.transpose(1, 2).half())


def test_flash_attention_bf16_plan(card):
    """The bf16 kernel's launch shapes: three warpgroups sharing K/V at
    smollm-135m's g = 3, two q tiles a block at MLA's g = 1, q and K
    streamed in d-chunks once q no longer fits, dv above 256 over the grid."""
    serve = fa.bf16_plan(8, 9, 3, 2048, 64, 64)
    assert (serve["warpgroups"], serve["keys_a_tile"], serve["q_resident"]) == (3, 64, 1)
    assert serve["blocks"] == 8 * 3 * 32
    mla = fa.bf16_plan(1, 16, 16, 4096, 192, 128)
    assert (mla["warpgroups"], mla["keys_a_tile"], mla["blocks"]) == (2, 64, 16 * 32)
    assert mla["smem_bytes"] <= 232448
    wide = fa.bf16_plan(1, 2, 1, 200, 640, 64)
    assert wide["q_resident"] == 0 and wide["d_blocks_an_item"] < 10
    assert fa.bf16_plan(1, 2, 1, 100, 320, 288)["dv_chunks"] == 2


def test_lm_prefill_and_decode_on_card_match_cpu(card):
    """A two-layer dense LM (smollm-135m's widths) at fp32: prefill and
    greedy decode through serve.generate on the card, and the same tokens
    through the CPU from the same weights; K11 launches once per layer in the
    card's prefill (s = 70: a ragged key tile)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM

    cfg = replace(get_config("smollm-135m"), n_layers=2, dtype=torch.float32)
    model = LM(cfg)
    params = model.init(0, device="cpu")
    on_card = tree_map(lambda t: t.to(card), params)
    prompts = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(0))
    before = fa.LAUNCHES["flash_attention"]
    res_card = serve.generate(model, on_card, prompts.to(card), 4)
    assert fa.LAUNCHES["flash_attention"] == before + cfg.n_layers
    # the CPU decodes the card's tokens, so a near-tie cannot fork the runs
    logits, cache = model.prefill(params, {"tokens": prompts})
    cache = serve.grow_cache(cache, 4)
    for i, a in enumerate(res_card["logits"]):
        if i:
            tok = res_card["tokens"][:, i - 1:i]
            logits, cache = model.decode_step(params, cache, {"tokens": tok}, 70 + i - 1)
        b = logits.float()
        assert (a.cpu().float() - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("b,h,kv,s,d,dv", [(4, 64, 4, 2048, 128, 128),
                                             (4, 16, 16, 2048, 192, 128)])
def test_flash_attention_moe_prefill_shapes_within_gate(card, b, h, kv, s, d, dv):
    """bf16 causal at qwen3-moe-235b-a22b's prefill (GQA, g = 16) and
    deepseek-v2-lite-16b's (MLA: d = 128 + 64 rope, dv 128), 4 x 2048 tokens."""
    g = torch.Generator(device=card).manual_seed(b * h * s + d)
    q = torch.randn((b, h, s, d), generator=g, device=card).bfloat16()
    k = torch.randn((b, kv, s, d), generator=g, device=card).bfloat16()
    v = torch.randn((b, kv, s, dv), generator=g, device=card).bfloat16()
    before = fa.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    plain = fa.flash_attention_plain(q, k, v)
    err = (out.float() - plain.float()).abs()
    assert bool((err <= _bf16_ulp(plain) + 2e-5).all())
    assert err.max().item() <= 3e-2 * max(1.0, plain.float().abs().max().item())


def _moe_cfg(arch, **kw):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(arch), dtype=torch.float32, n_layers=1, **kw)


def _route_gate(cfg, cpu, card):
    """Tokens whose routing differs between the devices (the top k in order
    and the pairs kept), each a near-tie on the CPU (k-th and (k+1)-th
    probabilities within 1e-6); returns the mask of those tokens."""
    t, k = cpu["top_e"].shape
    differs = ((cpu["top_e"] != card["top_e"].cpu()).any(1)
               | (cpu["keep"].view(t, k) != card["keep"].cpu().view(t, k)).any(1))
    srt = torch.sort(cpu["probs"], dim=-1, descending=True).values
    tie = srt[:, k - 1] - srt[:, k] <= 1e-6
    assert not bool((differs & ~tie).any())
    return differs


def _routing(params, x, cfg):
    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1])
    probs, _, top_e = moe.route(params, xt, cfg)
    _, keep = moe.dispatch(top_e, cfg.n_experts, moe.capacity(cfg, xt.shape[0]))
    return {"probs": probs.cpu(), "top_e": top_e, "keep": keep}


@pytest.mark.parametrize("arch,experts", [("qwen3-moe-235b-a22b", 16),
                                          ("deepseek-v2-lite-16b", 64)])
def test_moe_forward_on_card_matches_cpu(card, arch, experts):
    """``moe_forward`` at the architecture's width (qwen3's experts cut to
    16, its top-8 kept), fp32, 2 x 96 tokens: the routing first, then y
    within 1e-3 x max(1, max|y|) on the tokens routed alike, aux too where
    every token is."""
    from repro_torch.models import moe
    from repro_torch.models.param import materialize

    cfg = _moe_cfg(arch, n_experts=experts)
    params = materialize(moe.moe_decl(cfg), 1, device="cpu")
    on_card = tree_map(lambda t: t.to(card), params)
    x = torch.randn((2, 96, cfg.d_model), generator=torch.Generator().manual_seed(2))
    y, aux = moe.moe_forward(params, x, cfg)
    y_g, aux_g = moe.moe_forward(on_card, x.to(card), cfg)
    differs = _route_gate(cfg, _routing(params, x, cfg), _routing(on_card, x.to(card), cfg))
    rows = ~differs
    y, y_g = y.reshape(-1, cfg.d_model)[rows], y_g.cpu().reshape(-1, cfg.d_model)[rows]
    assert (y_g - y).abs().max().item() <= 1e-3 * max(1.0, y.abs().max().item())
    if not bool(differs.any()):
        assert abs(aux_g.item() - aux.item()) <= 1e-3 * max(1.0, abs(aux.item()))


def test_mla_block_on_card_matches_cpu(card):
    """One deepseek-v2-lite-16b block at its width and fp32: the prefill
    (K11 at d = 192, dv = 128) with its c / kr cache and two absorbed decode
    steps from the CPU's cache, within 1e-3 x max(1, max|x|) on the tokens
    routed alike."""
    from repro_torch.models import blocks
    from repro_torch.models.param import materialize

    cfg = _moe_cfg("deepseek-v2-lite-16b")
    params = materialize(blocks.decoder_block_decl(cfg), 3, device="cpu")
    on_card = tree_map(lambda t: t.to(card), params)
    x = torch.randn((2, 66, cfg.d_model), generator=torch.Generator().manual_seed(4))
    pos = torch.arange(66)
    before = fa.LAUNCHES["flash_attention"]
    y, _, cache = blocks.decoder_block_forward(params, x[:, :64], pos[:64], cfg,
                                               collect_cache=True)
    y_g, _, cache_g = blocks.decoder_block_forward(on_card, x[:, :64].to(card),
                                                   pos[:64].to(card), cfg, collect_cache=True)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert set(cache) == {"c", "kr"}

    def rel(a, b):
        return (a.cpu() - b).abs().max().item() / max(1.0, b.abs().max().item())

    for key in cache:
        assert rel(cache_g[key], cache[key]) <= 1e-3
    # the MoE's input on the CPU's side, routed on both devices
    from repro_torch.models import attention
    from repro_torch.models.layers import rmsnorm

    h = rmsnorm(params["ln_attn"], x[:, :64], cfg.norm_eps)
    h = rmsnorm(params["ln_mlp"], x[:, :64] + attention.mla_forward(params["attn"], h, pos[:64],
                                                                     cfg), cfg.norm_eps)
    rows = ~_route_gate(cfg, _routing(params["moe"], h, cfg),
                        _routing(on_card["moe"], h.to(card), cfg))
    assert rel(y_g.reshape(-1, cfg.d_model)[rows.to(card)],
               y.reshape(-1, cfg.d_model)[rows]) <= 1e-3
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 2)) for k, c in cache.items()}
    for t in (64, 65):
        mine = {k: c.to(card) for k, c in cache.items()}
        o_g, mine = blocks.decoder_block_decode(on_card, x[:, t:t + 1].to(card), mine, t, cfg)
        o, cache = blocks.decoder_block_decode(params, x[:, t:t + 1], cache, t, cfg)
        assert rel(o_g, o) <= 1e-3
        for key in cache:
            assert rel(mine[key][:, t], cache[key][:, t]) <= 1e-3


def test_moe_lm_init_on_card_equals_cpu(card):
    """``LM.init`` draws every leaf on the host in chunks, scales it on the
    device and casts it there: the card's weights equal the CPU's bit for
    bit (bf16 and the fp32 router)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    model = LM(get_config("deepseek-v2-lite-16b").reduced(dtype=torch.bfloat16))
    on_card, on_cpu = model.init(0, device=card), model.init(0, device="cpu")
    for a, b in zip(tree_leaves(on_card), tree_leaves(on_cpu)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _k11b_gate(got, plain, dtype):
    """K11b's gate: fp32 1e-4 x max(1, max|plain|); bf16 one bf16 ULP of
    plain plus that (plain: autograd of the plain forward on the fp32
    inputs, rounded once to the inputs' dtype)."""
    plain = plain.to(dtype).float()
    err = (got.float() - plain).abs()
    cap = 1e-4 * max(1.0, plain.abs().max().item())
    if dtype == torch.float32:
        return err.max().item() <= cap
    return bool((err <= _bf16_ulp(plain) + cap).all())


# K11b: every K11 shape, dtype and mask at unit scale, and chip_smoke.py's
# K11_LARGE_V bf16 causal shapes with v at a model's scale (x 60), where P
# and dS in bf16 parts must hold the unchanged gate
# (tests/test_torch_flash_bwd_numerics.py)
K11B_CASES = [(*shape, dtype, causal, window, 1.0) for shape in K11_SHAPES
              for dtype in (torch.float32, torch.bfloat16)
              for causal, window in ((True, 0), (True, 48), (False, 0), (False, 48))] + [
    (*shape, torch.bfloat16, True, 0, 60.0)
    for shape in ((2, 4, 2, 512, 64, 64), (1, 4, 2, 256, 128, 128))]


@pytest.mark.parametrize("b,h,kv,s,d,dv,dtype,causal,window,v_scale", K11B_CASES)
def test_flash_attention_backward_kernel_matches_plain(card, b, h, kv, s, d, dv, dtype, causal,
                                                       window, v_scale):
    g = torch.Generator(device=card).manual_seed(b * h * s + d + 1)
    q, k, v, do = (torch.randn(shape, generator=g, device=card) for shape in
                   ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv), (b, h, s, dv)))
    q, k, v, do = q.to(dtype), k.to(dtype), (v * v_scale).to(dtype), do.to(dtype)
    if dtype == torch.bfloat16:  # rows TMA cannot load go through a zero-padded copy
        for t in (q, k, v, do):
            assert (fa._tma_ready(t) is not t) == (t.shape[-1] * 2 % 16 != 0)
    _, lse, o_acc = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    _, lse_p, _ = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                           return_lse=True)
    assert (lse - lse_p).abs().max().item() <= 2e-5
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_backward(q, k, v, o_acc, lse, do, causal=causal, window=window)
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(fa.flash_attention_plain(*leaves, causal=causal, window=window),
                                leaves, do.float())
    for a, p, t in zip(got, plain, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
        assert _k11b_gate(a, p, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_launches_are_bit_equal(card, dtype):
    """The backward is deterministic (no atomics): two launches on the same
    inputs give the same bits, at smollm-135m's head shape."""
    b, h, kv, s, d = 2, 9, 3, 300, 64
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v, do = (torch.randn(shape, generator=g, device=card).to(dtype) for shape in
                   ((b, h, s, d), (b, kv, s, d), (b, kv, s, d), (b, h, s, d)))
    _, lse, o_acc = fa.flash_attention(q, k, v, return_lse=True)
    first = fa.flash_attention_backward(q, k, v, o_acc, lse, do)
    again = fa.flash_attention_backward(q, k, v, o_acc, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_backward_bf16_plan(card):
    """K11b's bf16 plan: two consumer warpgroups and four stages at the
    training widths, one warpgroup past them, P and dS in two bf16 parts;
    widths past 14 64-column blocks raise, and so does the backward on them."""
    assert fa.bwd_bf16_plan(64, 64) == dict(warpgroups=2, stages=4, p_ds_parts=2,
                                            dkdv_chunks=1, dq_chunks=1, smem_bytes=99400)
    hd128 = fa.bwd_bf16_plan(128, 128)
    assert (hd128["warpgroups"], hd128["stages"], hd128["dkdv_chunks"],
            hd128["dq_chunks"]) == (2, 4, 2, 1)
    wide = fa.bwd_bf16_plan(640, 64)
    assert (wide["warpgroups"], wide["stages"], wide["dkdv_chunks"],
            wide["dq_chunks"]) == (1, 1, 6, 5)
    with pytest.raises(RuntimeError):
        fa.bwd_bf16_plan(640, 320)
    q = torch.zeros((1, 2, 64, 640), dtype=torch.bfloat16, device=card)
    v = torch.zeros((1, 1, 64, 320), dtype=torch.bfloat16, device=card)
    o_acc = torch.zeros((1, 2, 64, 320), device=card)
    lse = torch.zeros((1, 2, 64), device=card)
    before = fa.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(RuntimeError):
        fa.flash_attention_backward(q, q[:, :1], v, o_acc, lse, o_acc.bfloat16())
    assert fa.LAUNCHES["flash_attention_bwd"] == before


def test_flash_attention_function_on_card_reads_strides(card):
    """The model's (b, s, h, d) activations through ops.flash_attention with
    gradients: one forward and one backward launch, gradients in the
    inputs' memory order and equal to the backward called directly."""
    g = torch.Generator(device=card).manual_seed(5)
    q0, k0, v0, do = (torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
                      for shape in ((2, 70, 6, 64), (2, 70, 2, 64), (2, 70, 2, 64),
                                    (2, 70, 6, 64)))
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    before = dict(fa.LAUNCHES)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              window=16).transpose(1, 2)
    out.backward(do)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert q.grad.is_contiguous() and k.grad.is_contiguous()
    _, lse, o_acc = fa.flash_attention(q0.transpose(1, 2), k0.transpose(1, 2),
                                       v0.transpose(1, 2), window=16, return_lse=True)
    ref = fa.flash_attention_backward(q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
                                      o_acc, lse, do.transpose(1, 2), window=16)
    for a, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(a, r.transpose(1, 2))
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
                                    o_acc.cpu(), lse, do.transpose(1, 2))


def test_lm_train_step_on_card_matches_cpu(card):
    """One launch.train step of a two-layer reduced smollm (fp32) on the card
    and the CPU from one state: loss within 1e-4, each parameter within 1e-4
    x max(1, max|leaf|) plus 2 lr_1 (AdamW's step where a near-zero gradient
    rounds to opposite signs); K11 and K11b once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw, cosine_schedule

    cfg = get_config("smollm-135m").reduced()
    model = LM(cfg)
    opt = adamw(cosine_schedule(3e-4, warmup=10, total=30), weight_decay=0.01)
    step = build_train_step(model, opt, 2)
    p_cpu = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(TokenStream(cfg.vocab_size, 4, 64)).items()}
    before = dict(fa.LAUNCHES)
    p_card, _, m_card = step(tree_map(lambda t: t.to(card), p_cpu),
                             opt.init(tree_map(lambda t: t.to(card), p_cpu)),
                             {k: v.to(card) for k, v in batch.items()})
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + cfg.n_layers
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + cfg.n_layers
    p_ref, _, m_ref = step(p_cpu, opt.init(p_cpu), batch)
    assert abs(float(m_card["loss"]) - float(m_ref["loss"])) <= 1e-4 * max(
        1.0, abs(float(m_ref["loss"])))
    lr_1 = 3e-4 / 10
    for a, b in zip(tree_leaves(p_card), tree_leaves(p_ref)):
        scale = max(1.0, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale + 2 * lr_1


def test_baselines_on_card_match_cpu(card):
    """tests/test_baselines.py's suite: TCA, CORAL and JDA give the CPU's
    accuracy on the card; source-only within 0.02."""
    from repro_torch import baselines

    doms = make_domains(3, 250, shift=1.0, seed=5)
    s, t = doms[:2], doms[2]
    for fn in (lambda d: baselines.tca_baseline(s, t, gamma=1e-3, m=16, device=d),
               lambda d: baselines.coral_baseline(s, t, device=d),
               lambda d: baselines.jda_baseline(s, t, gamma=1e-3, iters=2, device=d)):
        assert fn(card) == fn("cpu")
    assert abs(baselines.source_only(s, t, device=card)
               - baselines.source_only(s, t, device="cpu")) <= 0.02
