"""Decoder iterations a codeword over the traced window: an early-stop
decode's per-codeword counts summed on the device, a fixed decode's
budget, over the codewords decoded (the program's counters). None where
the program does not count them."""


def read(ctx):
    try:
        from ldpc_sims_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    n = TRACE.counters["codewords"]
    return TRACE.iterations() / n if n else None
