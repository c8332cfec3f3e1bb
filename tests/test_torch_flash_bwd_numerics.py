"""The numerics of K11b's bf16 tile loops on the tensor cores, modelled on the CPU.

``csrc/flash_attention_bwd.cu`` runs on the card only, so the arithmetic of
its bf16 kernels is modelled here in plain torch.  Q, K, V and dO are bf16,
so the score products S = Q K^T and dP = dO V^T are exact products summed
in fp32; P = exp(S / sqrt(d) - lse) and dS = P (dP - D) are fp32 (D =
rowsum(dO o) from the forward's fp32 output).  P and dS enter the bf16
products dV += P^T dO, dK += dS^T Q and dQ += dS K as ``parts`` bf16 pieces
(``hi = bf16(x)``, ``mid = bf16(x - hi)``, ...; each remainder exact in
fp32).  Each wgmma step of 16 rows of the reduction adds each part's
product (exact, summed) into one fp32 accumulator, rounding toward zero as
the tensor cores' fp32 additions do; the dK/dV accumulator runs over the
whole band of every query head of the group (the GQA sum in the block),
the dQ accumulator over the key tiles of the band.  The gradients are
rounded once to bf16.

The model is held to K11b's bf16 gate (``chip_smoke.py`` phase 15,
``tests/test_torch_cuda.py``) against ``flash_attention_backward_plain``:
one bf16 ULP of plain plus 1e-4 x max(1, max|plain|).  The cases record
how many parts P and dS need, at unit scale and with v at a model's scale
(x 60, ``chip_smoke.py``'s ``K11_LARGE_V``): two parts hold the gate
everywhere, a single bf16 rounding (one plain bf16 product) does not.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

STEP = 16  # rows of the reduction a wgmma step takes (k of m64nNk16)
RTOL = 1e-4  # K11B_RTOL: on max(1, max|plain|)
PARTS = 2  # the kernel's pieces of P and dS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's small products: the suite runs in
    parallel workers, where each one's pools would contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def split(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """fp32 x as ``parts`` bf16 pieces (as fp32 values), largest first."""
    out = []
    for _ in range(parts):
        hi = x.bfloat16().float()
        out.append(hi)
        x = x - hi  # exact in fp32
    return out


def add_rz(acc: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """fp32 acc + float64 term, rounded toward zero (a tensor-core addition)."""
    exact = acc.double() + term
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def product(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a (..., M, R) b (..., R, N) as the kernels take it: fp32 a in
    ``parts`` bf16 pieces, bf16 b, steps of 16 of R, each piece's exact
    product added into one fp32 accumulator rounding toward zero."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    pa = split(a, parts)
    bd = b.double()
    for r0 in range(0, a.shape[-1], STEP):
        for piece in pa:
            acc = add_rz(acc, piece[..., r0:r0 + STEP].double() @ bd[..., r0:r0 + STEP, :])
    return acc


def backward_model(q, k, v, o, lse, do, *, causal, window, parts=PARTS):
    """(dq, dk, dv) in bf16 from the kernels' arithmetic: bf16 q (b, h, s,
    d), k, v (b, kv, s, .), do; fp32 o (the forward's output before its
    rounding) and lse (b, h, s)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    f32 = torch.float32
    dof = do.float()
    delta = torch.sum(dof * o, dim=-1, keepdim=True)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    # exact products of bf16 values summed in fp32
    sc = (q.double() @ kk.double().transpose(-1, -2)).to(f32)
    dp = (do.double() @ vv.double().transpose(-1, -2)).to(f32)
    keep = fa._keep_mask(s, causal, window, "cpu")
    scale = 1.0 / math.sqrt(d)
    p = torch.where(keep, torch.exp(sc * scale - lse[..., None]), torch.zeros((), dtype=f32))
    ds = p * (dp - delta)
    # dK/dV: one accumulator a key row over the group's query heads and the
    # band's query tiles (rows of P^T and dS^T; the reduction runs over the
    # queries of each head in turn)
    pt = p.transpose(-1, -2).reshape(b, kv, g, s, s).permute(0, 1, 3, 2, 4).reshape(b, kv, s,
                                                                                    g * s)
    dst = ds.transpose(-1, -2).reshape(b, kv, g, s, s).permute(0, 1, 3, 2, 4).reshape(b, kv, s,
                                                                                      g * s)
    dv = product(pt, do.reshape(b, kv, g * s, -1), parts)
    dk = product(dst, q.reshape(b, kv, g * s, d), parts) * scale
    dq = product(ds, kk.bfloat16(), parts) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126))) - 7)


def gate_units(got, plain):
    """max |got - plain| / (one bf16 ULP of plain + 1e-4 x max(1, max|plain|))."""
    plain = plain.float()
    cap = RTOL * max(1.0, float(plain.abs().max()))
    return float(((got.float() - plain).abs() / (_bf16_ulp(plain) + cap)).max())


def _inputs(b, h, kv, s, d, dv, seed, v_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv), (b, h, s, dv)))
    return tuple(torch.from_numpy(x).bfloat16() for x in (q, k, v * np.float32(v_scale), do))


def _units(shape, causal, window, parts, v_scale, seed):
    q, k, v, do = _inputs(*shape, seed=seed, v_scale=v_scale)
    _, lse, o = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    plain = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal, window=window)
    got = backward_model(q, k, v, o, lse, do, causal=causal, window=window, parts=parts)
    return [gate_units(a, p) for a, p in zip(got, plain)]


# small shapes of chip_smoke.py's K11_CHECK (the sweep, ragged s) and its
# K11_LARGE_V at v x 60, cut to s <= 256 for the CPU
SHAPES = [(1, 2, 1, 128, 32, 32), (2, 4, 2, 128, 16, 16), (2, 8, 2, 64, 64, 64),
          (2, 9, 3, 77, 64, 64), (1, 2, 1, 100, 20, 12)]
MASKS = [(True, 0), (True, 48), (False, 0), (False, 48)]
LARGE_V = [(1, 4, 2, 256, 64, 64), (1, 4, 2, 128, 128, 128)]
CASES = ([(shape, causal, window, 1.0) for shape in SHAPES for causal, window in MASKS]
         + [(shape, True, 0, 60.0) for shape in LARGE_V])


@pytest.mark.parametrize("shape,causal,window,v_scale", CASES)
def test_two_parts_hold_the_gate(shape, causal, window, v_scale):
    units = _units(shape, causal, window, PARTS, v_scale, seed=sum(shape) + window)
    assert max(units) <= 1.0, f"dq, dk, dv at {units} gate units"


@pytest.mark.parametrize("shape,v_scale", [((2, 9, 3, 77, 64, 64), 1.0), (LARGE_V[0], 60.0)])
def test_one_part_misses_the_gate(shape, v_scale):
    """One bf16 rounding of P and dS carries 2^-9 of each term into sums that
    cancel, beyond 1e-4 of the largest gradient."""
    units = _units(shape, True, 0, 1, v_scale, seed=sum(shape))
    assert max(units) > 1.0, f"one part within the gate: {units}"
