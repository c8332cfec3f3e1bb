"""The stats pass's counted least time over its kernels' device time, a fit, %."""
from portbench.counts import least_seconds

LAYER = "stats"  # layers/stats.json


def read(t):
    fits, dev = t.work.get("fits"), t.layer_seconds(LAYER)
    if not fits or not dev or t.peak is None:
        return None
    return 100.0 * least_seconds(t.counts["stats_flops"], t.counts["stats_bytes"], t.peak) * fits / dev
