"""Device milliseconds of the decode kernels a step, by kernel name, over
the traced window's steps."""

from portbench.layers import decode_seconds


def read(ctx):
    s = decode_seconds(ctx["trace"])
    return None if s is None else s / ctx["steps"] * 1e3
