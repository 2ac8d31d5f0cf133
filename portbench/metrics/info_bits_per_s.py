"""Info bits of every step completed in the window over the window's wall
seconds (the host's clock)."""


def read(ctx):
    k = ctx["config"]["code"]["k"]
    return ctx["steps"] * ctx["batch"] * k / ctx["window_s"]
