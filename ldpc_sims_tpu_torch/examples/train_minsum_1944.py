"""Train a per-iteration (α, β) min-sum schedule for (1944,972) layered-10,
freeze it into the kernels' α/β table and measure its BER beside plain
min-sum, sum-product and flooding-20 on paired noise (the port of the JAX
package's ``examples/train_minsum_1944.py``).

1. ``train_minsum_weights`` (adam at 0.02, seed 0) through the unrolled
   plain decode on all-zero-codeword BPSK batches at Es/N0 uniform in
   1.25-2.5 dB a codeword (a gradient decode: the roll backend);
2. four arms on paired frames at 1.5, 1.75 and 2.0 dB, info bits counted
   (the systematic prefix), ``$MS_BITS_PER_POINT`` info bits a point: plain
   and trained min-sum layered-10, sum-product layered-10 (the quality
   ceiling; ``sumproduct_qc_layered`` on the card) and plain min-sum
   flooding-20. The frames of step ``i`` at SNR ``s`` come from
   ``stable_seed(42, int(s·100), i)`` (:mod:`.paired`);
3. ms a step (frames, decode, one read; the median of 6) of plain and
   trained layered-10 at 2.0 dB.

The record (the JAX script's keys, plus ``stats``: each point's frames in
error and the BER's standard error from the per-frame counts) goes to
``$MS_OUT``, default ``outputs/<stamp>_minsum_trained_<schedule><iters>.json``.

Run:  python -m ldpc_sims_tpu_torch.examples.train_minsum_1944
Env:  MS_ITERS (10), MS_SCHEDULE (layered), MS_BITS_PER_POINT (1e9),
      MS_EVAL_BATCH (32768), MS_TRAIN_STEPS (120), MS_TRAIN_BATCH (256),
      MS_DEVICE (cuda; cpu runs the plain version), MS_OUT.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.paired import count_errors, step_ms
from ldpc_sims_tpu_torch.ops.bp import freeze_minsum_weights
from ldpc_sims_tpu_torch.training import TrainConfig, train_minsum_weights
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["CODE", "EVAL_SNRS", "KEY", "TRAIN_SNR", "main", "run", "settings"]

TRAIN_SNR = (1.25, 2.5)  # Es/N0 dB, the waterfall region
EVAL_SNRS = (1.5, 1.75, 2.0)
KEY = 42  # the paired frames' key
# the code the JAX script runs (run() takes any library QC code)
CODE = "wifi1944"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``MS_*`` variables."""
    env = os.environ.get
    return dict(
        iters=int(env("MS_ITERS", "10")),
        schedule=env("MS_SCHEDULE", "layered"),
        bits_per_point=float(env("MS_BITS_PER_POINT", "1e9")),
        batch=int(env("MS_EVAL_BATCH", "32768")),
        train_steps=int(env("MS_TRAIN_STEPS", "120")),
        train_batch=int(env("MS_TRAIN_BATCH", "256")),
        device=env("MS_DEVICE", "cuda"),
        out=env("MS_OUT", ""),
    )


def run(dev, iters: int = 10, schedule: str = "layered",
        bits_per_point: float = 1e9, batch: int = 32768,
        train_steps: int = 120, train_batch: int = 256,
        code: str = CODE) -> dict:
    """Train, then the four paired arms and the timings on ``dev``;
    returns the record."""
    code = get_code(code)
    log(f"device {dev}, code {code.name}")
    t0 = time.time()
    ms, info = train_minsum_weights(
        code, TrainConfig(optimizer="adam", learning_rate=0.02, seed=0),
        iterations=iters, schedule=schedule, snr_db=TRAIN_SNR,
        steps=train_steps, batch=train_batch, log=log, device=dev)
    alpha, beta = freeze_minsum_weights(ms)
    log(f"trained in {time.time() - t0:.0f}s")
    log("alpha: " + ",".join(f"{a:.4f}" for a in alpha))
    log("beta:  " + ",".join(f"{b:.4f}" for b in beta))

    arms = {
        "minsum_plain_layered10": dict(iterations=iters, schedule=schedule),
        "minsum_trained_layered10": dict(iterations=iters, schedule=schedule,
                                         alpha=alpha, beta=beta),
        "sumproduct_layered10": dict(iterations=iters, schedule=schedule,
                                     method="sum-product"),
        "minsum_plain_flooding20": dict(iterations=20),
    }
    steps = max(int(bits_per_point / (batch * code.k)), 1)
    nbits = steps * batch * code.k
    ber = {name: {} for name in arms}
    stats = {name: {} for name in arms}
    for snr in EVAL_SNRS:
        for name, kw in arms.items():
            t0 = time.time()
            c = count_errors(code, kw, snr, steps, batch, KEY, dev,
                             info_bits=True)
            ber[name][str(snr)] = c.ber
            stats[name][str(snr)] = {"frame_errs": c.frame_errs,
                                     "ber_se": c.ber_se}
            log(f"{name} @{snr} dB: BER {c.ber:.3e} ({c.bit_errs} errs / "
                f"{nbits:.1e} bits, {c.frame_errs} frames, "
                f"{time.time() - t0:.1f}s)")

    times = {}
    for name in ("minsum_plain_layered10", "minsum_trained_layered10"):
        dt = step_ms(code, arms[name], batch, KEY, dev) / 1e3
        times[name] = {"ms_per_step": dt * 1e3,
                       "info_bits_per_s": batch * code.k / dt}
        log(f"{name}: {dt * 1e3:.2f} ms/step, "
            f"{batch * code.k / dt:.3e} info bits/s")
    return {
        "what": (
            "Trained per-iteration normalized/offset min-sum "
            f"({schedule}-{iters}) on {code.name}; BER at "
            f"{bits_per_point:.0e} info bits/point, paired noise across "
            "arms, all-zero codeword (symmetry argument: min-sum is "
            "sign-symmetric)."
        ),
        "train": {"snr_db": list(TRAIN_SNR), "steps": train_steps,
                  "batch": train_batch, "loss_first": info["loss"][0],
                  "loss_last": info["loss"][-1]},
        "alpha": list(alpha), "beta": list(beta),
        "eval_batch": batch, "bits_per_point": nbits,
        "ber": ber, "stats": stats, "throughput": times,
        "device": str(dev),
    }


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    out = cfg.pop("out")
    rec = run(dev, code=CODE, **cfg)
    path = out or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_minsum_trained_"
                   f"{cfg['schedule']}{cfg['iters']}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
