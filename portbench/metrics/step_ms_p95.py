"""The 95th percentile of the wall time of every step in the window, each
step ending in its host read of the counts (the host's clock), linear
between the closest ranks."""


def read(ctx):
    s = sorted(ctx["step_s"])
    pos = (len(s) - 1) * 0.95
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return (s[lo] + (s[hi] - s[lo]) * (pos - lo)) * 1e3
