"""Operations and bytes of the benchmark's work, from the shapes alone.

The counts are the least that the mathematics needs, whatever implements it,
so that a faster implementation can never push a share of a peak past 100 %:

- stats pass: 2Npn (Omega X) + 2N(2N+1)n (the upper triangle of the
  symmetric Gram, with its diagonal) + 4Nn (u); bytes: X read once (4pn),
  G_H (2N x 2N) and u written once;
- fit: the stats pass plus 2(2N)^2 m, the least a top-m solve touches
  (eigensolver work beyond it, whitening and trigonometry go uncounted);
- transform, a column: 2Np (featurize) + 4Nm (projection); the featurize
  kernel's bytes a column: X's column read (4p), its (2N,) output written (8N).

``PEAKS`` holds the published dense rates of the cards the benchmark runs on,
keyed by the name ``torch.cuda.get_device_name()`` gives.  Shares are stated
against the TF32 rate: the program's products take fp32 operands, and TF32
is the card's published rate on them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: TF32 dense 495 TFLOP/s, HBM3 3.35 TB/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes_s": 3.35e12},
}


def stats_flops(n_features: int, dim: int, n: int) -> float:
    nf = n_features
    return 2.0 * nf * dim * n + 2.0 * nf * (2 * nf + 1) * n + 4.0 * nf * n


def stats_bytes(n_features: int, dim: int, n: int) -> float:
    return 4.0 * dim * n + 4.0 * (2 * n_features) ** 2 + 4.0 * 2 * n_features


def solve_flops(n_features: int, m: int) -> float:
    return 2.0 * (2 * n_features) ** 2 * m


def fit_flops(n_features: int, dim: int, n: int, m: int) -> float:
    return stats_flops(n_features, dim, n) + solve_flops(n_features, m)


def featurize_flops_per_col(n_features: int, dim: int) -> float:
    return 2.0 * n_features * dim


def featurize_bytes_per_col(n_features: int, dim: int) -> float:
    return 4.0 * dim + 8.0 * n_features


def transform_flops_per_col(n_features: int, dim: int, m: int) -> float:
    return featurize_flops_per_col(n_features, dim) + 4.0 * n_features * m


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The roofline's least time: the larger of the compute and the memory bound."""
    return max(flops / peak["flops"], nbytes / peak["bytes_s"])


def for_config(cfg: dict) -> dict:
    """Every count the metric readers use, for one configuration."""
    nf, p, m = cfg["n_features"], cfg["dim"], cfg["m"]
    n = cfg["n_source"] + cfg["n_target"]
    return {
        "stats_flops": stats_flops(nf, p, n),
        "stats_bytes": stats_bytes(nf, p, n),
        "fit_flops": fit_flops(nf, p, n, m),
        "featurize_flops_per_col": featurize_flops_per_col(nf, p),
        "featurize_bytes_per_col": featurize_bytes_per_col(nf, p),
        "transform_flops_per_col": transform_flops_per_col(nf, p, m),
    }
