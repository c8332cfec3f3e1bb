"""The share of the traced window of transforms in which no operation ran on the device, %."""


def read(t):
    if not t.work.get("columns") or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
