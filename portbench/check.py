"""Whether the timed path's counts are right: the plain reference
recomputes a sample of the window's steps from their seeds.

For each sampled step the reference draws the step's inputs from a
generator seeded as the program's was, runs the link and decodes in
blocks of rows, and counts. The numbers compared are the gaps between the
program's six counts and the reference's, summed over the sample:

- ``uncoded_err_gap``: the channel's hard-decision errors (the encode,
  the modulation, the OFDM transform, the noise and the LLRs);
- ``coded_err_gap`` and ``frame_err_gap``: the decoded info-bit and frame
  errors (the decode's dispatch and kernels);
- ``bits_gap``, ``info_bits_gap`` and ``frames_gap``: the sizes every BER
  and BLER is divided by (the counts).

Each is held to the traffic's limit for it.
"""

from __future__ import annotations

import torch

from portbench.reference.channel import transmit
from portbench.reference.code import Code
from portbench.reference.decode import Decoder

NUMBERS = ("uncoded_err_gap", "coded_err_gap", "frame_err_gap",
           "bits_gap", "info_bits_gap", "frames_gap")
BLOCK = 8192  # codewords a reference decode


def reference(config: dict, traffic: dict, device,
              storage: str = "float32"):
    """The reference's code and decoder for a cell; ``storage`` is the
    type its float tensors are stored in (``reference_counts`` takes the
    decoder's)."""
    c = config["code"]
    code = Code(c["base"], c["z"], c["k"])
    d = traffic["decoder"]
    dec = Decoder(code, device, d["method"], d["schedule"], d["iterations"],
                  alpha=d["alpha"], beta=d["beta"], clamp=d["clamp"],
                  early_stop=d["early_stop"], storage=storage)
    return code, dec


def reference_counts(code, dec, config: dict, traffic: dict, batch: int,
                     seed: int, device) -> tuple[list[int], int]:
    """The six counts of the step drawn from ``seed``, in the order of
    ``harness.COUNT_KEYS``, and the iterations its codewords ran."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    coded, llr = transmit(gen, code, batch, config["link"]["ofdm_size"],
                          traffic["snrdb"], dec.storage)
    k, n = code.k, code.n
    unc = int(((llr > 0).to(torch.int8) != coded).sum())
    info_err = frame_err = ran = 0
    for lo in range(0, batch, BLOCK):
        bits, iters = dec.decode(llr[lo:lo + BLOCK])
        want = coded[lo:lo + BLOCK]
        info_err += int((bits[:, :k] != want[:, :k]).sum())
        frame_err += int((bits != want).any(1).sum())
        ran += int(iters.sum())
    return [unc, info_err, frame_err, batch * n, batch * k, batch], ran


def gaps(got: list[int], want: list[int]) -> dict[str, int]:
    """The gap of each count, in the order of ``harness.COUNT_KEYS``."""
    return {k: abs(int(a) - int(b)) for k, a, b in zip(NUMBERS, got, want)}


def judge(config: dict, traffic: dict, batch: int, device,
          steps: list[tuple[int, list[int]]]) -> dict:
    """Hold the program's counts of ``steps`` ((seed, counts) pairs) to
    the reference's."""
    code, dec = reference(config, traffic, device)
    total = dict.fromkeys(NUMBERS, 0)
    failed, ran = 0, []
    limits = traffic["limits"]
    for seed, got in steps:
        want, r = reference_counts(code, dec, config, traffic, batch, seed,
                                   device)
        ran.append(r)
        g = gaps(got, want)
        failed += any(g[k] > limits[k] for k in NUMBERS)
        for k in NUMBERS:
            total[k] += g[k]
    checks = {k: {"value": total[k], "limit": limits[k]} for k in NUMBERS}
    correct = bool(steps) and all(total[k] <= limits[k] for k in NUMBERS)
    return {"correct": correct, "failed": failed, "checks": checks,
            "iterations_run": sum(ran) / len(ran) if ran else None}
