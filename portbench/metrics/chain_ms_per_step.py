"""Device milliseconds a step of every kernel, copy and fill that is not a
decode kernel: the RNG, the encode GEMM, modulation, OFDM, the LLRs and
the counts."""

from portbench.layers import chain_seconds


def read(ctx):
    s = chain_seconds(ctx["trace"])
    return None if s is None else s / ctx["steps"] * 1e3
