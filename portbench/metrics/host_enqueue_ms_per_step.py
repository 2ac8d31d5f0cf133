"""Host milliseconds a step inside the program's step span
(ldpc.mc.step): its launches, and any wait in a host sync inside it, over
the traced window's steps. None where the program has no such span."""


def read(ctx):
    try:
        from ldpc_sims_tpu_torch.utils.metrics import STEP, TRACE
    except ImportError:
        return None
    if not TRACE.steps:
        return None
    return TRACE.host_seconds(STEP) / TRACE.steps * 1e3
