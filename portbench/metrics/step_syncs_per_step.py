"""Host syncs a step inside the program's step span (ldpc.mc.step), as
torch's own sync detection reports them, over the traced window's steps.
0 on the CPU, where a step has no device to wait for. None where the
program does not count them."""


def read(ctx):
    try:
        from ldpc_sims_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    if not TRACE.steps:
        return None
    return TRACE.counters["syncs"] / TRACE.steps
