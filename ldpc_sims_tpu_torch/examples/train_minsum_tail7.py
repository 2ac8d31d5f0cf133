"""Tail-targeted layered-7 (α, β) fine-tune (the port of the JAX package's
``examples/train_minsum_tail7.py``).

A wide-window trained layered-7 schedule passed waterfall parity but
floored at 2.5-3.5 dB; a passing 7-sweep schedule would lift the rate at
equal BER by 8/7. The hypothesis: uniform-SNR training starves the tail
(the BCE gradient is dominated by the low-SNR frames, where errors are
plentiful). So this recipe

1. warm-starts from the trained-8 schedule's 7-entry prefix in the
   committed registry (``docs/artifacts/minsum_trained_schedules.json``);
2. draws each training frame's SNR from a mixture (:func:`mixture_snr_db`):
   with probability 0.7 uniform in [2.25, 3.75) dB (the floor region),
   else uniform in [1.25, 2.25) (the waterfall); adam at $T7_LR through
   the unrolled plain decode (a gradient decode: the roll backend), the
   frames from a generator seeded with 17;
3. watches held-out decoded BER at 2.0, 2.75 and 3.5 dB (16384 frames
   each) every tenth of the run through ``training.decoded_ber_probe``:
   a hard decode under ``no_grad``, which on the card runs the α/β-table
   kernel where the JAX script decodes on roll; the hard bits are the
   same, the kernels equal to the plain version bit for bit;
4. guards the frozen schedule against the flooding-20 control on paired
   frames (key 55, 31 × 32768 frames a point, every coded bit counted) at
   1.75, 2.25 (waterfall) and 2.75, 3.25 dB (floor):
   :func:`guard_verdict` gives the verdict a point.

The record goes to $T7_OUT (default ``outputs/<stamp>_tail7.json``). A
schedule that passes at every point is promoted to ``layered.7`` in a copy
of the registry beside the record (``<record>_schedules.json``; no
``floor_ok`` until the full campaign); the committed registry is read,
never written.

Run:  python -m ldpc_sims_tpu_torch.examples.train_minsum_tail7
Env:  T7_STEPS (3000), T7_BATCH (512), T7_LR (3e-3), T7_DEVICE (cuda; cpu
      runs the plain version), T7_OUT.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.error_floor_campaign import (
    REGISTRY,
    relocate_registry,
)
from ldpc_sims_tpu_torch.examples.paired import count_errors
from ldpc_sims_tpu_torch.ops.bp import freeze_minsum_weights
from ldpc_sims_tpu_torch.parallel.mc import stable_seed
from ldpc_sims_tpu_torch.training import TrainConfig, decoded_ber_probe
from ldpc_sims_tpu_torch.training.trainer import minsum_step
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["CODE", "EVAL_BATCH", "EVAL_STEPS", "FLOOR", "GUARD", "K",
           "PROBE_BATCH", "guard_verdict", "main", "mixture_llrs",
           "mixture_snr_db", "optimizer", "promote", "run", "settings",
           "train_step"]

K = 7
GUARD = (1.75, 2.25)
FLOOR = (2.75, 3.25)
PROBE_SNRS = (2.0, 2.75, 3.5)
PROBE_BATCH = 16384
EVAL_BATCH = 32768
EVAL_STEPS = 31
TRAIN_KEY = 17  # the training frames' and the probes' key
KEY = 55  # the guard's paired frames' key
# the code the JAX script runs (run() takes any library QC code)
CODE = "wifi1944"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``T7_*`` variables."""
    env = os.environ.get
    return dict(steps=int(env("T7_STEPS", "3000")),
                batch=int(env("T7_BATCH", "512")),
                lr=float(env("T7_LR", "3e-3")),
                device=env("T7_DEVICE", "cuda"),
                out=env("T7_OUT", ""))


def mixture_snr_db(gen: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 1) Es/N0 in dB, a row each: a Bernoulli(0.7) hit draws
    uniform in [2.25, 3.75) (the floor region), a miss uniform in [1.25,
    2.25) (the waterfall)."""
    dev = gen.device
    pick = torch.rand((batch, 1), generator=gen, device=dev) < 0.7
    lo = 1.25 + torch.rand((batch, 1), generator=gen, device=dev)
    hi = 2.25 + 1.5 * torch.rand((batch, 1), generator=gen, device=dev)
    return torch.where(pick, hi, lo)


def mixture_llrs(gen: torch.Generator, code, batch: int) -> torch.Tensor:
    """A training batch: all-zero codewords over BPSK/AWGN at the mixture's
    SNRs, drawn on the generator's device."""
    snr = 10.0 ** (mixture_snr_db(gen, batch) / 10.0)
    sigma = torch.rsqrt(snr)
    r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                  device=gen.device)
    return -2.0 * r / (sigma * sigma)


def optimizer(weights: dict, lr: float) -> torch.optim.Optimizer:
    """``optax.adam(lr)`` over the ms arrays."""
    return TrainConfig(optimizer="adam", learning_rate=lr).make_optimizer(
        weights.values())


def train_step(weights: dict, opt, code, llr: torch.Tensor) -> torch.Tensor:
    """One step: the BCE of the soft layered-K decode (K the schedule's
    length) against the all-zero codeword, on the roll backend; returns
    the loss."""
    return minsum_step(weights, opt, code, llr,
                       iterations=len(weights["ms_alpha"]),
                       schedule="layered", backend="roll")


def guard_verdict(ctrl: dict, tail7: dict) -> dict:
    """Per point (keys ``str(snr)``), whether the schedule's bit errors
    stay within the control's ``c``: at most 1.15·c + 5·√c + 20."""
    return {s: bool(tail7[s] <= c * 1.15 + 5.0 * math.sqrt(c) + 20)
            for s, c in ctrl.items()}


def promote(reg: dict, code_name: str, alpha, beta,
            artifact: str) -> dict:
    """``reg`` with the tuned schedule as its ``layered.7`` entry
    (``parity_ok``, the record's name; ``floor_ok`` only after the full
    campaign), as a new dict."""
    reg = copy.deepcopy(reg)
    reg[code_name]["layered"][str(K)] = {
        "alpha": list(alpha), "beta": list(beta), "parity_ok": True,
        "artifact": artifact}
    return reg


def run(dev, steps: int = 3000, batch: int = 512, lr: float = 3e-3,
        eval_batch: int = EVAL_BATCH, eval_steps: int = EVAL_STEPS,
        probe_batch: int = PROBE_BATCH, registry: str = REGISTRY,
        code: str = CODE) -> dict:
    """The fine-tune, its probes and the paired guard on ``dev``; returns
    the record."""
    with open(registry) as f:
        t8 = json.load(f)[code]["layered"]["8"]  # keyed by library name
    code = get_code(code)
    ms = {k: torch.tensor(t8[src][:K], dtype=torch.float32, device=dev,
                          requires_grad=True)
          for k, src in (("ms_alpha", "alpha"), ("ms_beta", "beta"))}
    log(f"warm start from trained-8 prefix: a={t8['alpha'][:K]}")
    opt = optimizer(ms, lr)
    probe = decoded_ber_probe(code, PROBE_SNRS, batch=probe_batch,
                              device=dev, iterations=K, method="min-sum",
                              schedule="layered")
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_KEY)
    losses, probes = [], []
    t0 = time.time()
    for i in range(steps):
        losses.append(train_step(ms, opt, code,
                                 mixture_llrs(gen, code, batch)))
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            bers = probe(ms, stable_seed(TRAIN_KEY, 10**6 + i))
            probes.append({"step": i,
                           "ber": {str(s): v for s, v in bers.items()}})
            log(f"[{i + 1}/{steps}] BCE {float(losses[-1]):.5f} probe "
                + " ".join(f"{s}:{v:.2e}" for s, v in bers.items())
                + f" ({time.time() - t0:.0f}s)")
    losses = torch.stack(losses).tolist()
    al, be = freeze_minsum_weights(ms)
    log("alpha: " + ",".join(f"{a:.3f}" for a in al))
    log("beta:  " + ",".join(f"{b:.3f}" for b in be))

    def errs(tag: str, **kw) -> tuple[dict, dict]:
        out, stats = {}, {}
        for s in GUARD + FLOOR:
            c = count_errors(code, kw, s, eval_steps, eval_batch, KEY, dev)
            out[str(s)] = c.bit_errs
            stats[str(s)] = {"frame_errs": c.frame_errs, "ber_se": c.ber_se,
                             "coded_bits": c.bits}
            log(f"{tag} @{s}: BER {c.ber:.3e} ({c.bit_errs} errs, "
                f"{c.frame_errs} frames)")
        return out, stats

    ctrl, ctrl_stats = errs("flooding-20", iterations=20)
    t7, t7_stats = errs("tail-tuned layered-7", iterations=K,
                        schedule="layered", alpha=al, beta=be)
    verdict = guard_verdict(ctrl, t7)
    for s, ok in verdict.items():
        log(f"@{s}: {'OK' if ok else 'WORSE'} ({t7[s]} vs ctrl {ctrl[s]})")
    return {
        "what": "tail-targeted layered-7 fine-tune (warm from trained-8"
                " prefix, 30/70 waterfall/floor SNR mixture)",
        "steps": steps, "batch": batch, "lr": lr,
        "alpha": list(al), "beta": list(be),
        "bce": [losses[0], losses[-1]], "probes": probes,
        "guard_errs": {"ctrl": ctrl, "tail7": t7},
        "guard_stats": {"ctrl": ctrl_stats, "tail7": t7_stats},
        "verdict": verdict, "device": str(dev),
    }


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    out = cfg.pop("out")
    res = run(dev, eval_batch=EVAL_BATCH, eval_steps=EVAL_STEPS,
              probe_batch=PROBE_BATCH, registry=REGISTRY, code=CODE, **cfg)
    path = out or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_tail7.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"record -> {path}")
    if all(res["verdict"].values()):
        reg_out = os.path.splitext(path)[0] + "_schedules.json"
        with open(REGISTRY) as f:
            reg = relocate_registry(
                json.load(f), os.path.dirname(REGISTRY),
                os.path.dirname(os.path.abspath(reg_out)))
        with open(reg_out, "w") as f:
            json.dump(promote(reg, CODE, res["alpha"], res["beta"],
                              os.path.basename(path)), f, indent=1)
        log(f"registry copy with the tail-tuned layered-7 (pending the "
            f"full floor campaign): {reg_out}")
    else:
        log("verdict: NOT promoted (guard failed) — recorded honestly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
