"""Density-evolution threshold table and measured-waterfall validation (the
port of the JAX package's ``examples/de_thresholds.py``).

For every QC code in the library this computes the protograph DE
threshold (:mod:`ldpc_sims_tpu_torch.codes.de`: sampled DE with the
decoder's own exclusive check rules) at the decoder's iteration budget
(min-sum, 20) and at the asymptotic one (150, min-sum and sum-product),
then measures the code's BPSK min-sum flooding-20 waterfall (its 1e-3 BER
crossing, bisected with ``bp_decode``, on the CUDA kernels on the card)
and records the finite-length gap. Verdict per code:

    consistent  iff  0 < (measured 1e-3 crossing) − th20 < gap_max

with gap_max 0.8 dB from n = 1500 up and 1.2 dB below. A negative gap
(beating DE) flags a broken measurement; a large one a broken
construction (girth, shifts) or LLR scaling.

Run:  python -m ldpc_sims_tpu_torch.examples.de_thresholds
Env:  DE_CODES (comma list; default every QC library code), DE_MEASURE=0
      (skip the waterfall), DE_SAMPLES (8192), DE_BATCH (8192), DE_DEVICE
      (cuda; cpu runs the plain version), DE_OUT
      (outputs/<stamp>_de_thresholds.json).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes import get_code, list_codes
from ldpc_sims_tpu_torch.codes.de import de_threshold
from ldpc_sims_tpu_torch.ops.bp import bp_decode
from ldpc_sims_tpu_torch.parallel.mc import stable_seed
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["code_entry", "main", "measured_crossing"]


def log(m: str) -> None:
    print(m, file=sys.stderr, flush=True)


def measured_crossing(code, batch: int, dev, target: float = 1e-3,
                      lo: float = 0.0, hi: float = 6.0,
                      steps: int = 20) -> float:
    """Bisect (9 halvings) the BPSK min-sum flooding-20 waterfall's BER
    crossing of ``target``: all-zero codewords, ``r = 1 + σ·n``, LLR
    (log Pr1/Pr0) = −2r/σ², up to ``steps`` batches a point (step ``i``
    at ``snr_db`` seeded ``stable_seed(7, int(1000·snr_db), i)``),
    stopping a point once it has seen 3000 bit errors."""

    def ber(snr_db: float) -> float:
        sigma = (10.0 ** (snr_db / 10.0)) ** -0.5
        errs = bits = 0
        for i in range(steps):
            gen = torch.Generator(device=dev)
            gen.manual_seed(stable_seed(7, int(snr_db * 1000), i))
            r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                          device=dev)
            out = bp_decode(-2.0 * r / (sigma * sigma), code, iterations=20,
                            method="min-sum")
            errs += int(out.sum(dtype=torch.int64))
            bits += batch * code.n
            if errs > 3000:  # plenty to call a crossing
                break
        return errs / bits

    for _ in range(9):
        mid = 0.5 * (lo + hi)
        if ber(mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def code_entry(name: str, samples: int, batch: int, measure: bool,
               dev) -> dict:
    """One code's row: its three DE thresholds and, with ``measure``, the
    measured crossing, the gap and the verdict."""
    code = get_code(name)
    base = np.asarray(code.qc.base)
    kw = dict(samples=samples, snr_lo_db=-1.0, snr_hi_db=8.0, device=dev)
    t0 = time.time()
    th20 = de_threshold(base, method="min-sum", iterations=20, **kw)
    th_inf = de_threshold(base, method="min-sum", iterations=150, **kw)
    th_sp = de_threshold(base, method="sum-product", iterations=150, **kw)
    ent = {
        "n": code.n, "k": code.k, "rate": code.rate,
        "th_minsum_20it_db": round(th20, 3),
        "th_minsum_db": round(th_inf, 3),
        "th_sumproduct_db": round(th_sp, 3),
        "de_wall_s": round(time.time() - t0, 1),
    }
    log(f"{name}: th(ms,20)={th20:.2f} th(ms)={th_inf:.2f} "
        f"th(sp)={th_sp:.2f} dB  [{ent['de_wall_s']}s]")
    if measure:
        t0 = time.time()
        cross = measured_crossing(code, batch, dev,
                                  lo=max(th20 - 1.0, -1.0), hi=th20 + 3.0)
        gap = cross - th20
        gap_max = 0.8 if code.n >= 1500 else 1.2
        ent.update(
            measured_1e3_crossing_db=round(cross, 3),
            gap_db=round(gap, 3),
            gap_max_db=gap_max,
            consistent=bool(0.0 < gap < gap_max),
            measure_wall_s=round(time.time() - t0, 1),
        )
        log(f"{name}: measured 1e-3 crossing {cross:.2f} dB, gap "
            f"{gap:+.2f} dB -> "
            f"{'CONSISTENT' if ent['consistent'] else 'INCONSISTENT'}")
    return ent


def main() -> int:
    env = os.environ.get
    samples = int(env("DE_SAMPLES", str(1 << 13)))
    batch = int(env("DE_BATCH", "8192"))
    measure = env("DE_MEASURE", "1") == "1"
    dev = resolve_device(env("DE_DEVICE", "cuda"))
    names = [c for c in (env("DE_CODES").split(",") if env("DE_CODES")
                         else list_codes())
             if c and get_code(c).qc is not None]
    log(f"device: {dev}")
    table = {name: code_entry(name, samples, batch, measure, dev)
             for name in names}
    path = env("DE_OUT") or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_de_thresholds.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "what": (
                "protograph DE thresholds (sampled DE, decoder's own "
                "check rules; snr = 1/sigma^2 BPSK units) vs measured "
                "min-sum flooding-20 waterfall crossings"
            ),
            "samples": samples, "batch": batch, "device": str(dev),
            "codes": table,
        }, f, indent=1)
    log(f"record -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
