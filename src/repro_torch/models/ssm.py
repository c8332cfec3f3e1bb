"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Port of ``repro.models.ssm``.  Prefill and training run the chunked SSD
algorithm (the paper's "minimal SSD"): a quadratic, attention-like product
inside chunks of length Q and a linear recurrence across the chunk states,
O(S Q) instead of O(S^2).  The reference writes it in jnp (no Pallas
kernel), so the port writes it in plain torch: fp32 products through
``torch.einsum`` / ``torch.matmul`` (TF32 stays off, torch's default), the
recurrence across chunks a loop on the device with no host sync.  Two of the
reference's einsums take three operands; torch would contract them left to
right, the first through a (b, c, l, n, h) outer product, so the decays are
folded into the other operand first (the same sums).

Decode is the O(1)-per-token recurrent update of the (H, P, N) state, kept
in fp32 (the reference's prefill and decode produce it in fp32) and written
in place, as the port writes the attention caches.

Convention: G (ssm groups) = 1, B/C shared across heads within the group.
The depthwise causal conv runs over the packed (x, B, C) channels as in
Mamba2; decode keeps a (W-1)-deep shift register of the raw projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDecl

F32 = torch.float32
NORM_EPS = 1e-5  # the gated RMSNorm's eps: a literal in the reference, not cfg.norm_eps


def ssm_decl(cfg: ModelConfig) -> dict:
    d, di, n, h, w = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_conv_width
    return {
        "w_z": ParamDecl((d, di), "normal", cfg.dtype),
        "w_x": ParamDecl((d, di), "normal", cfg.dtype),
        "w_b": ParamDecl((d, n), "normal", cfg.dtype),
        "w_c": ParamDecl((d, n), "normal", cfg.dtype),
        "w_dt": ParamDecl((d, h), "normal", cfg.dtype),
        "dt_bias": ParamDecl((h,), "ssm_dt", F32),
        "a_log": ParamDecl((h,), "ssm_a", F32),
        "d_skip": ParamDecl((h,), "ones", F32),
        "conv_x": ParamDecl((w, di), "normal", cfg.dtype, 0.5),
        "conv_b": ParamDecl((w, n), "normal", cfg.dtype, 0.5),
        "conv_c": ParamDecl((w, n), "normal", cfg.dtype, 0.5),
        "norm": ParamDecl((di,), "ones", cfg.dtype),
        "w_out": ParamDecl((di, d), "normal", cfg.dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (b, s, ch); w: (width, ch).  The taps are
    added in the reference's order, each product and sum in x's dtype."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] = sum_{j<k<=i} a_k."""
    seq = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((seq, seq), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def chunk_len(chunk: int, s: int) -> int:
    """The reference's chunk: ``min(chunk, s)``, halved until it divides s."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (b, s, h, p); dt: (b, s, h) (post-softplus); a_log:
    (h,); b_in, c_in: (b, s, n).  Returns (y (b, s, h, p) in x's dtype, the
    final state (b, h, p, n) in fp32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = chunk_len(chunk, s)
    nc = s // q
    a = -torch.exp(a_log.to(F32))  # (h,)
    abar = dt.to(F32) * a  # (b, s, h)

    xc = x.reshape(bsz, nc, q, h, p)
    bc = b_in.reshape(bsz, nc, q, n).to(F32)
    cc = c_in.reshape(bsz, nc, q, n).to(F32)
    dtc = dt.reshape(bsz, nc, q, h).to(F32)
    ac = abar.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)  # (b, h, nc, q)
    a_cs = torch.cumsum(ac, dim=-1)  # (b, h, nc, q)

    # 1) intra-chunk (diagonal blocks)
    l_mat = torch.exp(_segsum(ac))  # (b, h, nc, q, q)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)  # (b, nc, q, q)
    m = scores[:, None] * l_mat  # (b, h, nc, q, q)
    del l_mat
    # dt-weighted input enters the state: weight x by dt
    xdt = xc.to(F32) * dtc[..., None]  # (b, nc, q, h, p)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", m, xdt)
    del m

    # 2) per-chunk states: "bcln,bhcl,bclhp->bchpn" with the decay folded into x
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)  # (b, h, nc, q)
    states = torch.einsum("bcln,bclhp->bchpn", bc,
                          xdt * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cs[..., -1])  # (b, h, nc)
    prev = torch.empty((bsz, nc, h, p, n), dtype=F32, device=x.device)
    carry = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]

    # 4) inter-chunk outputs: "bcln,bchpn,bhcl->bclhp" with the decay applied after
    state_decay = torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]  # (b, nc, q, h, 1)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev) * state_decay

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full Mamba2 block body (the pre-norm residual is the caller's).

    x: (b, s, d) -> (b, s, d); with return_state also the decode-ready
    {"ssm": (b, h, p, n) fp32, "conv": (b, w-1, ch)} cache, the conv leaf the
    last w-1 raw projections (zeros in front of a prompt shorter than that)."""
    h, p = cfg.ssm_n_heads, cfg.ssm_head_dim
    z = x @ params["w_z"]
    xs_raw = x @ params["w_x"]
    bb_raw = x @ params["w_b"]
    cb_raw = x @ params["w_c"]
    dt_raw = x @ params["w_dt"]

    xs = F.silu(_causal_conv(xs_raw, params["conv_x"]))
    bb = F.silu(_causal_conv(bb_raw, params["conv_b"]))
    cb = F.silu(_causal_conv(cb_raw, params["conv_c"]))
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])

    bsz, s, _ = x.shape
    xh = xs.reshape(bsz, s, h, p)
    y, final_state = ssd_chunked(xh, dt, params["a_log"], bb, cb, cfg.ssm_chunk)
    # y is rounded to x's dtype before the fp32 skip term, as the reference does
    y = y + xh.to(F32) * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, h * p).to(x.dtype)
    out = _gated_norm_out(params, y, z)
    if return_state:
        w = cfg.ssm_conv_width
        packed = torch.cat([xs_raw, bb_raw, cb_raw], dim=-1)  # pre-conv
        tail = F.pad(packed[:, -(w - 1):, :], (0, 0, max(0, w - 1 - s), 0))
        return out, {"ssm": final_state, "conv": tail.to(x.dtype)}
    return out


def _gated_norm_out(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mamba2's gated RMSNorm, then the output projection."""
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.to(F32)), dim=-1, keepdim=True)
    y = (y.to(F32) * torch.rsqrt(var + NORM_EPS)).to(z.dtype) * params["norm"]
    return y @ params["w_out"]


# ---------------------------------------------------------------------------
# decode: O(1) recurrent update
# ---------------------------------------------------------------------------

def ssm_decode(params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """Single-token step. x: (b, 1, d); state = {"ssm": (b, h, p, n) fp32,
    "conv": (b, w-1, ch)}, both updated in place (the reference returns new
    ones).  Returns (out (b, 1, d), state)."""
    h, p, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    bsz = x.shape[0]
    xt = x[:, 0, :]
    z = xt @ params["w_z"]
    packed = torch.cat([xt @ params["w_x"], xt @ params["w_b"], xt @ params["w_c"]], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_b"], params["conv_c"]], dim=1)
    hist = torch.cat([state["conv"], packed[:, None, :]], dim=1)  # (b, w, ch)
    # "bwc,wc->bc": exact products, an fp32 sum, one rounding
    conv_out = F.silu(torch.sum(hist.to(F32) * conv_w.to(F32), dim=1).to(x.dtype))
    xs, bb, cb = torch.split(conv_out, [cfg.d_inner, n, n], dim=-1)
    state["conv"].copy_(hist[:, 1:, :])

    dt = F.softplus((xt @ params["w_dt"]).to(F32) + params["dt_bias"])  # (b, h)
    a = -torch.exp(params["a_log"].to(F32))
    da = torch.exp(dt * a)  # (b, h)
    xh = xs.reshape(bsz, h, p).to(F32)
    ssm = state["ssm"]
    if ssm.dtype != F32:
        raise ValueError(f"the SSM state is kept in fp32, not {ssm.dtype}")
    # state * da + "bh,bn,bhp->bhpn"
    ssm.mul_(da[..., None, None]).add_((dt[..., None] * xh)[..., None]
                                       * bb.to(F32)[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cb.to(F32), ssm)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bsz, h * p).to(x.dtype)
    return _gated_norm_out(params, y, z)[:, None, :], state


def ssm_ref_sequential(x, dt, a_log, b_in, c_in):
    """Pure recurrence oracle: an O(S) loop over the tokens, no chunking.
    Returns (y (b, s, h, p), the final state (b, h, p, n)), both fp32 (the
    reference returns y alone)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    a = -torch.exp(a_log.to(F32))
    dt, b_in, c_in = dt.to(F32), b_in.to(F32), c_in.to(F32)
    state = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)  # (b, h)
        state = state * da[..., None, None] + (
            (dt[:, t, :, None] * x[:, t].to(F32))[..., None] * b_in[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, t], state))
    return torch.stack(ys, dim=1), state
