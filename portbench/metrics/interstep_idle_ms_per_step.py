"""Device milliseconds a step between steps: from the CUDA event at the
end of each of the program's step spans (ldpc.mc.step) to the one at the
start of the next, summed over the traced window and divided by its
steps. None on the CPU and where the program has no such span."""


def read(ctx):
    try:
        from ldpc_sims_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    s = TRACE.gap_seconds()
    return None if s is None or not TRACE.steps else s / TRACE.steps * 1e3
