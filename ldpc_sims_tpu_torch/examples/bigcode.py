"""Scale run: the 5G-class QC codes (n = 8448, 12288) on one H100.

The counterpart of the JAX package's ``examples/bigcode_tpu.py``. Per code
it measures the device-resident decode rate (random LLRs ``N(0,1)·2 − 4``
from an explicit CUDA generator, ``PIPE`` decodes launched back to back
with one synchronization, the median of 3 timed repetitions after one
warm-up) of flooding-20 at f32 and layered-10 at f32, bf16 and int8
(``msg_qclip=24``), then a paired-noise BER check near the waterfall:
all-zero codewords on the BPSK channel ``r = 1 + σn``, ``σ = snr^-½``,
``llr = −2r/σ²``, 8 × ``BATCH`` frames per point, each batch decoded by
flooding-20 f32 and by layered-10 at each storage type on the same LLRs.
These codes are where bf16 and int8 storage matter on the H100: at f32 a
codeword's state (121-175 KB) fills an SM's shared memory, bf16 and int8
halve it or better (``kernels/minsum_qc.py:smem_bytes``).

Run:  python -m ldpc_sims_tpu_torch.examples.bigcode   (needs a CUDA card)
Env:  BIG_CODES (qc8448_r12,qc12288_r12), BIG_BATCH (16384), BIG_PIPE (16),
      BIG_SNRS (1.75,2.25), BIG_OUT (outputs/<stamp>_bigcode.json).

Writes one JSON record; every rate is beside the card's name and count.
Without a card it exits non-zero: there is no CPU branch.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.ops import bp_decode

__all__ = ["CONFIGS", "ber_point", "main", "pipe_rate", "run", "summarize"]

# (label, bp_decode arguments) of the rate configurations; the BER check
# decodes the same four on shared LLRs
CONFIGS = {
    "flooding-20 f32": dict(iterations=20),
    "layered-10 f32": dict(iterations=10, schedule="layered"),
    "layered-10 bf16": dict(iterations=10, schedule="layered",
                            dtype=torch.bfloat16),
    "layered-10 int8": dict(iterations=10, schedule="layered",
                            dtype=torch.int8, msg_qclip=24.0),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pipe_rate(code, batch: int, pipe: int, device="cuda", **kw) -> dict:
    """ms per decode and decoded info bits/s of ``pipe`` back-to-back
    decodes of fresh random LLRs on ``device`` (one synchronization), the
    median of 3 timed repetitions after one warm-up (``bp_decode``
    arguments ``kw``)."""
    gen = torch.Generator(device=device)

    def run_pipe(s: int) -> None:
        gen.manual_seed(s)
        acc = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(pipe):
            llr = torch.randn((batch, code.n), generator=gen,
                              device=device) * 2.0 - 4.0
            acc += bp_decode(llr, code, method="min-sum", **kw).sum(
                dtype=torch.int64)
        int(acc)  # the one synchronization

    t0 = time.perf_counter()
    run_pipe(999)
    warm_s = time.perf_counter() - t0
    ts = []
    for i in range(3):
        t0 = time.perf_counter()
        run_pipe(i)
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    return {"ms_per_step": dt * 1e3 / pipe,
            "info_bits_per_s": batch * code.k * pipe / dt,
            "warmup_s": warm_s, "rep_s": ts}


def ber_point(code, snrdb: float, batch: int) -> dict:
    """Paired-noise BER of each configuration at one SNR: per-frame bit
    error counts ((8·batch,) int64 on the card, by label) of every
    configuration on the same all-zero-codeword BPSK LLRs, 8 batches."""
    sigma = (10.0 ** (snrdb / 10.0)) ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33_000 + int(round(snrdb * 100)))
    errs = {label: [] for label in CONFIGS}
    for _ in range(8):
        r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                      device="cuda")
        llr = -2.0 * r / sigma**2
        for label, kw in CONFIGS.items():
            bits = bp_decode(llr, code, method="min-sum", **kw)
            errs[label].append(bits.sum(dim=1, dtype=torch.int64))
    return {label: torch.cat(e) for label, e in errs.items()}


def summarize(errs: torch.Tensor, n: int) -> dict:
    """BER, its standard error from the per-frame counts, frames in
    error."""
    frames = errs.numel()
    e = errs.double()
    return {"ber": float(e.sum()) / (frames * n),
            "se": float(e.std()) / (frames**0.5 * n),
            "bit_errors": int(errs.sum()),
            "frames_in_error": int((errs > 0).sum()), "frames": frames}


def run(codes, batch: int, pipe: int, snrs) -> tuple[dict, dict]:
    """The whole run: rates and BER per code. Returns the record and the
    per-frame error counts ({code: {snr: {label: tensor}}})."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bigcode run needs a CUDA card")
    out = {"device": {"kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()},
           "batch": batch, "pipe": pipe, "codes": {}}
    frame_errs = {}
    for name in codes:
        code = get_code(name)
        ent = {"n": code.n, "k": code.k, "rate": code.rate}
        log(f"{name}: n={code.n} k={code.k}")
        for label, kw in CONFIGS.items():
            ent[label] = pipe_rate(code, batch, pipe, **kw)
            log(f"  {label}: {ent[label]['ms_per_step']:.3f} ms/step, "
                f"{ent[label]['info_bits_per_s']:.4e} info bits/s")
        ent["ber"], frame_errs[name] = {}, {}
        for snr in snrs:
            errs = ber_point(code, snr, batch)
            frame_errs[name][snr] = errs
            ent["ber"][str(snr)] = {label: summarize(e, code.n)
                                    for label, e in errs.items()}
            log(f"  BER @{snr}: " + ", ".join(
                f"{label} {v['ber']:.4e}"
                for label, v in ent["ber"][str(snr)].items()))
        out["codes"][name] = ent
    return out, frame_errs


def main() -> int:
    if not torch.cuda.is_available():
        print("bigcode: no CUDA device (torch.cuda.is_available() is "
              "false); this run has no CPU branch", file=sys.stderr)
        return 1
    codes = [c for c in os.environ.get(
        "BIG_CODES", "qc8448_r12,qc12288_r12").split(",") if c]
    batch = int(os.environ.get("BIG_BATCH", "16384"))
    pipe = int(os.environ.get("BIG_PIPE", "16"))
    snrs = tuple(float(x) for x in
                 os.environ.get("BIG_SNRS", "1.75,2.25").split(","))
    path = os.environ.get("BIG_OUT") or os.path.join(
        "outputs", time.strftime("%Y%m%d-%H%M%S") + "_bigcode.json")
    log(f"device: {torch.cuda.get_device_name(0)}")
    record, _ = run(codes, batch, pipe, snrs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    log(f"record -> {path}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
