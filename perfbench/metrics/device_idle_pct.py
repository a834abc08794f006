"""The share of the traced window in which no kernel, copy or fill ran on
the device: 100 · (1 − union of the device intervals / window)."""


def read(r):
    t = r.traced
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
