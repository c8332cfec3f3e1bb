"""Seeded domain pairs made on the device, and the bandwidth heuristic.

The law is the port's ``data.domains.make_domains`` (columns are samples):
shared class prototypes on a sphere of radius ``class_sep``; each domain a
mild rotation expm(0.35 shift S) of a random skew-symmetric S, an anisotropic
scale 1 + shift U(-0.4, 0.4), a shift 1.2 shift N(0, 1), and samples
prototype[y] + noise N(0, 1).  It is rewritten in torch so that the data is
drawn on the card by one ``torch.Generator`` in a few large calls, with a
domain's own column count (the source and the target differ in size).
"""
from __future__ import annotations

import torch

CHUNK = 32768  # columns drawn per call; fixed, so a seed gives one data set


def domain_pair(*, dim: int, n_source: int, n_target: int, n_classes: int, shift: float,
                class_sep: float, noise: float, generator: torch.Generator,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(X_S (dim, n_source), X_T (dim, n_target)), contiguous float32."""
    g, f64 = generator, torch.float64
    protos = torch.randn((n_classes, dim), generator=g, device=device, dtype=f64)
    protos *= class_sep / protos.norm(dim=1, keepdim=True)
    protos_t = protos.T.float().contiguous()
    out = []
    for n in (n_source, n_target):
        a = torch.randn((dim, dim), generator=g, device=device, dtype=f64)
        rot = torch.linalg.matrix_exp((a - a.T) * (0.5 * 0.35 * shift)).float()
        scale = 1.0 + shift * (torch.rand(dim, generator=g, device=device, dtype=f64) * 0.8 - 0.4)
        offset = 1.2 * shift * torch.randn(dim, generator=g, device=device, dtype=f64)
        scale, offset = scale.float()[:, None], offset.float()[:, None]
        y = torch.randint(0, n_classes, (n,), generator=g, device=device)
        x = torch.empty((dim, n), dtype=torch.float32, device=device)
        for c0 in range(0, n, CHUNK):
            c = min(CHUNK, n - c0)
            r = torch.randn((dim, c), generator=g, device=device)
            r.mul_(noise).add_(protos_t[:, y[c0:c0 + c]]).mul_(scale)
            x[:, c0:c0 + c] = torch.addmm(offset, rot, r)
        out.append(x)
    return out[0], out[1]


def median_sigma(x_s: torch.Tensor, x_t: torch.Tensor, *, subsample: int,
                 generator: torch.Generator) -> float:
    """sqrt(median |x_i - x_j|^2 / 2) over the pairs of ``subsample`` columns
    drawn without replacement from both domains (the median of an even count
    the mean of the middle two)."""
    n_s, n = x_s.shape[1], x_s.shape[1] + x_t.shape[1]
    idx = torch.randperm(n, generator=generator, device=x_s.device)[:subsample]
    src = idx[idx < n_s]
    x = torch.cat([x_s[:, src], x_t[:, idx[idx >= n_s] - n_s]], dim=1).double()
    sq = (x * x).sum(dim=0)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x.T @ x)).clamp_min(0.0)
    iu = torch.triu_indices(d.shape[0], d.shape[0], offset=1, device=d.device)
    off = torch.sort(d[iu[0], iu[1]]).values
    k = off.numel()
    med = off[k // 2] if k % 2 else 0.5 * (off[k // 2 - 1] + off[k // 2])
    return float(torch.sqrt(med / 2.0))
