"""K1's counted least time over its kernels' device time, across the window, %."""
from portbench.counts import least_seconds

LAYER = "featurize"  # layers/featurize.json


def read(t):
    cols, dev = t.work.get("columns"), t.layer_seconds(LAYER)
    if not cols or not dev or t.peak is None:
        return None
    least = least_seconds(t.counts["featurize_flops_per_col"], t.counts["featurize_bytes_per_col"],
                          t.peak)
    return 100.0 * least * cols / dev
