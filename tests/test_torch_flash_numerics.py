"""The numerics of K11's bf16 tile loop, modelled on the CPU.

``csrc/flash_attention.cu`` runs on the card only, so its arithmetic is
modelled here in plain torch: 64-key tiles, the online softmax in fp32 (in
log2 units, the finite -1e30 sentinel, p = 0 on masked keys), p split into
three bf16 parts ``p_hi = bf16(p)``, ``p_mid = bf16(p - p_hi)``, ``p_lo =
bf16(p - p_hi - p_mid)`` whose PV products accumulate in fp32, and the output
``acc / max(l, 1e-30)`` rounded once to bf16.  The model is held to the
kernel's gate against ``flash_attention_plain``: one bf16 ULP of the plain
output plus 2e-5, at most 3e-2 x max(1, max|plain|), equal non-finite
positions (``chip_smoke.py``'s K11 check, ``tests/test_torch_cuda.py``).
Cases record why p has three parts: a single bf16 rounding of p (one plain
bf16 PV product) lands far beyond the gate, and two parts (17 bits of p)
land beyond it once v has the scale of a model's activations (|v| ~ 60 in
smollm-135m's prefill), where an output that cancels is held to ~2e-5 and
two parts leave ~2^-17 |v|.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

BK = 64  # keys a tile
NEG_INF = -1e30
LOG2E = 1.4426950408889634
F32_ATOL, BF16_CAP = 2e-5, 3e-2

# chip_smoke.py's K11_SWEEP, the ragged shapes, MLA's widths
SHAPES = [(1, 2, 1, 128, 32, 32), (2, 4, 2, 128, 16, 16), (1, 4, 4, 256, 32, 16),
          (2, 8, 2, 64, 64, 64), (2, 9, 3, 77, 64, 64), (1, 9, 3, 1000, 64, 64),
          (1, 4, 4, 256, 192, 128)]
MASKS = [(True, 0), (True, 48), (False, 0), (False, 48)]


def tile_loop(q, k, v, *, causal, window, parts=3):
    """The kernel's tile loop on bf16 q (b, h, s, d), k, v, with p in
    ``parts`` bf16 pieces in the PV product; bf16 out."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_log2 = LOG2E / math.sqrt(d)
    m = torch.full((b, h, s, 1), NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, v.shape[-1]))
    i = torch.arange(s)[:, None]
    for k0 in range(0, s, BK):
        j = torch.arange(k0, min(k0 + BK, s))[None, :]
        keep = torch.ones((s, j.shape[1]), dtype=torch.bool)
        if causal:
            keep &= i >= j
        if window:
            keep &= (i - j) < window
        sc = torch.where(keep, qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2),
                         torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.where(keep, torch.exp2(sc * scale_log2 - m_new), torch.tensor(0.0))
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc
        for _ in range(parts):
            part = p.bfloat16().float()
            acc = acc + part @ vf[:, :, k0:k0 + BK]
            p = p - part  # exact in fp32
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126))) - 7)


def gate_ratio(out, plain):
    """max over positions of |out - plain| / (one bf16 ULP of plain + 2e-5);
    inf when the non-finite positions differ or the 3e-2 cap is passed."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(out), test(plain)):
            return math.inf
    ok = torch.isfinite(plain)
    err = (out.float() - plain.float()).abs()[ok]
    if float(err.max()) > BF16_CAP * max(1.0, float(plain.float()[ok].abs().max())):
        return math.inf
    return float((err / (_bf16_ulp(plain)[ok] + F32_ATOL)).max())


def _qkv(b, h, kv, s, d, dv, seed, v_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv)))
    return tuple(torch.from_numpy(x).bfloat16() for x in (q, k, v * np.float32(v_scale)))


LARGE_V = [(2, 4, 2, 512, 64, 64), (1, 4, 2, 256, 128, 128)]  # v x 60: a model's scale
CASES = ([(shape, causal, window, 3, 1.0) for shape in SHAPES for causal, window in MASKS]
         + [(shape, True, 0, parts, 60.0) for shape in LARGE_V for parts in (3, 2)]
         + [((2, 9, 3, 77, 64, 64), True, 0, 1, 1.0)])


@pytest.mark.parametrize("shape,causal,window,parts,v_scale", CASES)
def test_tile_loop_within_the_bf16_gate_only_with_p_in_three_parts(shape, causal, window, parts,
                                                                   v_scale):
    b, h, kv, s, d, dv = shape
    q, k, v = _qkv(*shape, seed=b * h * s + d + window, v_scale=v_scale)
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    ratio = gate_ratio(tile_loop(q, k, v, causal=causal, window=window, parts=parts), plain)
    if parts == 3:
        assert ratio <= 1.0, f"p in three parts: {ratio:.3f} of the gate"
    else:
        # one rounding of p carries its 2^-9 relative error, two parts 2^-17,
        # into outputs that cancel (early causal rows, sums of large v)
        assert ratio > 1.0, f"p in {parts} part(s) within {ratio:.3f} of the gate"


def test_tile_loop_window_of_one_keeps_the_diagonal():
    """Causal with a window of 1 keeps only the diagonal key: every earlier
    key of a row is masked, and the sentinel never turns into exp2(0) junk."""
    q, k, v = _qkv(1, 2, 1, 70, 16, 8, seed=3)
    out = tile_loop(q, k, v, causal=True, window=1)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=1)
    assert gate_ratio(out, plain) <= 1.0
    torch.testing.assert_close(out.float(), v.float().repeat_interleave(2, dim=1),
                               atol=0, rtol=0)
