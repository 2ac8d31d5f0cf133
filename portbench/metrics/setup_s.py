"""Seconds from the process's start to the first timed step: imports, the
CUDA context, the kernels' library (built on a checkout's first run), the
code, the step's construction and the warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
