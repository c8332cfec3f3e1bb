"""Counted FLOPs of the window's transforms over the window and the TF32 peak, %."""


def read(t):
    cols = t.work.get("columns")
    if not cols or t.peak is None or t.window_s <= 0:
        return None
    return 100.0 * t.counts["transform_flops_per_col"] * cols / t.window_s / t.peak["flops"]
