"""The share of the traced window in which no kernel, copy or fill ran on
the device: 1 - (union of the device's activity intervals) / window."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
