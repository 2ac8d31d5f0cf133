"""Paired-noise error counts and step timings for the training examples.

Every arm of an example decodes the same frames: the frames of step ``i``
at SNR ``s`` come from a generator seeded with ``stable_seed(key, int(s ·
100), i)`` on the device (the JAX scripts' ``fold_in(fold_in(key(key),
int(s·100)), i)``), whatever the decoder. Frames are all-zero codewords on
the BPSK-AWGN channel ``r = 1 + σ·n``, ``σ = snr^-½``, LLR (log Pr1/Pr0)
``= −2r/σ²``. The error counts of a point accumulate as int64 on the
device and are read once.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from ldpc_sims_tpu_torch.ops.bp import bp_decode
from ldpc_sims_tpu_torch.parallel.mc import stable_seed

__all__ = ["Counts", "bpsk_llrs", "count_errors", "frame_seed", "step_ms"]


def bpsk_llrs(code, snr_db: float, seed: int, batch: int,
              dev) -> torch.Tensor:
    """``batch`` all-zero-codeword frames at ``snr_db`` (Es/N0) from a
    generator seeded with ``seed`` on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sigma = (10.0 ** (snr_db / 10.0)) ** -0.5
    r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                  device=dev)
    return -2.0 * r / (sigma * sigma)


def frame_seed(key: int, snr_db: float, step: int) -> int:
    """The seed of step ``step``'s frames at ``snr_db`` under ``key``."""
    return stable_seed(key, int(snr_db * 100), step)


class Counts(NamedTuple):
    """A point's error counts: bit errors, frames in error, frames, bits
    counted, and the sum over frames of each frame's squared bit errors
    (for the standard error)."""

    bit_errs: int
    frame_errs: int
    frames: int
    bits: int
    sq_errs: int

    @property
    def ber(self) -> float:
        return self.bit_errs / self.bits

    @property
    def ber_se(self) -> float:
        """The BER's standard error from the per-frame counts: bit errors
        cluster in frames, so it exceeds the independent-bit figure."""
        mean = self.bit_errs / self.frames
        var = max(self.sq_errs / self.frames - mean * mean, 0.0)
        return math.sqrt(var / self.frames) * self.frames / self.bits


def count_errors(code, decode_kw: dict, snr_db: float, steps: int,
                 batch: int, key: int, dev, info_bits: bool = False
                 ) -> Counts:
    """The :class:`Counts` of ``steps`` decodes of ``batch`` paired frames
    with ``bp_decode(**decode_kw)``; over the first ``k`` bits of each
    codeword with ``info_bits`` (the systematic part), else over all
    ``n``."""
    width = code.k if info_bits else code.n
    acc = torch.zeros(3, dtype=torch.int64, device=dev)
    for i in range(steps):
        llr = bpsk_llrs(code, snr_db, frame_seed(key, snr_db, i), batch, dev)
        bits = bp_decode(llr, code, output="hard", **decode_kw)
        errs = bits[:, :width].sum(1, dtype=torch.int64)
        acc += torch.stack([errs.sum(), (errs > 0).sum(),
                            (errs * errs).sum()])
    bit_errs, frame_errs, sq_errs = acc.tolist()  # the point's one read
    return Counts(bit_errs, frame_errs, steps * batch, steps * batch * width,
                  sq_errs)


def step_ms(code, decode_kw: dict, batch: int, key: int, dev,
            snr_db: float = 2.0, reps: int = 6) -> float:
    """The JAX scripts' step timing: a step draws ``batch`` frames,
    decodes them and reads the info-bit error count; one warm-up step,
    then the median (the upper one for an even ``reps``) of ``reps`` timed
    steps, in ms."""
    def step(i: int) -> None:
        llr = bpsk_llrs(code, snr_db, stable_seed(key, 9000 + i), batch, dev)
        bits = bp_decode(llr, code, output="hard", **decode_kw)
        int(bits[:, :code.k].sum(dtype=torch.int64))  # waits for the card

    step(-1)
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        step(i)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] * 1e3
