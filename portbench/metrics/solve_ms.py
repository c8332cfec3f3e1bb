"""Device time of the solve's kernels (cuSOLVER's and cuBLAS's) a fit, ms."""

LAYER = "solve"  # layers/solve.json


def read(t):
    fits, dev = t.work.get("fits"), t.layer_seconds(LAYER)
    if not fits or not dev:
        return None
    return 1e3 * dev / fits
