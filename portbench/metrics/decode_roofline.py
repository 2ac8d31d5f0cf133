"""The decode's share of its roofline, in percent: the bound's
milliseconds a step (roofline/<method>-<schedule>.py against peaks.json)
over the decode kernels' device milliseconds a step."""

from portbench.layers import decode_seconds


def read(ctx):
    s = decode_seconds(ctx["trace"])
    if s is None or ctx["bound"] is None:
        return None
    return ctx["bound"]["ms"] / (s / ctx["steps"] * 1e3) * 100.0
