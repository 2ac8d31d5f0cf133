"""The min-sum layered decode's bytes and operations a step."""

from portbench.roofline import work as _work


def work(code, dec, batch, iterations_run):
    return _work(code, dec, batch, iterations_run, "min-sum", "layered")
