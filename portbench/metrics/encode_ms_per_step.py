"""Device milliseconds a step of the encode (the info bits drawn and
encoded): the device time of the program's span of it
(ldpc_sims_tpu_torch.utils.metrics), between the CUDA events at its
ends, over the traced window's steps. None on the CPU and where the
program has no such span."""


def read(ctx):
    try:
        from ldpc_sims_tpu_torch.utils.metrics import LINK_ENCODE, TRACE
    except ImportError:
        return None
    s = TRACE.device_seconds(LINK_ENCODE)
    return None if s is None or not TRACE.steps else s / TRACE.steps * 1e3
