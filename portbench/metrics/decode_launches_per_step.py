"""Decode kernel launches a step: the program's ENTRY_LAUNCHES counter
(kernels/minsum_qc.py) over the window, by the window's steps."""


def read(ctx):
    n = sum(ctx["launches"].values())
    return n / ctx["steps"] if n else None
