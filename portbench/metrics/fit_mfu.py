"""Counted FLOPs of the window's fits over the window and the TF32 peak, %."""


def read(t):
    fits = t.work.get("fits")
    if not fits or t.peak is None or t.window_s <= 0:
        return None
    return 100.0 * t.counts["fit_flops"] * fits / t.window_s / t.peak["flops"]
