"""The port's layers as the device trace shows them: the decode kernels
(``kernels/csrc/minsum_qc.cu``, every entry point's name starts with one
of ``DECODE_PREFIXES``) and everything else a step runs on the device,
the link chain's kernels (RNG, encode GEMM, modulation, OFDM, LLRs,
counts)."""

from __future__ import annotations

DECODE_PREFIXES = ("minsum_qc_", "sumproduct_qc_")


def is_decode(name: str) -> bool:
    return name.startswith(DECODE_PREFIXES)


def decode_seconds(trace: dict | None) -> float | None:
    """Device seconds of the decode kernels in the window, or None where
    the trace holds none."""
    if not trace:
        return None
    s = sum(v for k, v in trace["kernels"].items() if is_decode(k))
    return s if s > 0 else None


def chain_seconds(trace: dict | None) -> float | None:
    """Device seconds of every other kernel, copy and fill."""
    if not trace:
        return None
    s = sum(v for k, v in trace["kernels"].items() if not is_decode(k))
    return s if s > 0 else None
