"""Train short per-iteration (α, β) layered min-sum schedules for
(1944,972) and guard them against flooding-20's BER (the port of the JAX
package's ``examples/train_minsum_short.py``).

A trained layered-10 schedule beats flooding-20 by ~11× at the same
per-sweep cost, so a shorter trained schedule may reach flooding-20's BER
in fewer sweeps. This script

1. trains a layered-K schedule for each K in $MS_KS (adam at 0.02, seed
   K, Es/N0 uniform in $MS_TRAIN_SNR a codeword: the wide window keeps the
   high-SNR frames whose trapping sets short schedules give up);
2. runs a paired-noise guard against plain flooding-20 at the waterfall
   parity point (1.75 dB) and a high-SNR point (2.25 dB), info bits
   counted, $MS_EVAL_STEPS × $MS_EVAL_BATCH frames a point, the frames of
   step ``i`` at SNR ``s`` from ``stable_seed(42, int(s·100), i)``;
   :func:`parity_vs_flooding20` gives each schedule's verdict;
3. times each decode (ms a step, the median of 6);
4. writes the record to $MS_OUT (default
   ``outputs/<stamp>_minsum_short.json``) and the trained-schedule
   registry with the new entries (``alpha``, ``beta``, ``parity_ok``; no
   ``floor_ok`` until the error-floor campaign clears them) to a copy
   beside it, ``<record>_schedules.json``: the committed registry is read,
   never written (the copy's ``.npz`` paths are relative to its own
   directory).

Run:  python -m ldpc_sims_tpu_torch.examples.train_minsum_short
Env:  MS_KS (6,8), MS_TRAIN_SNR (1.25,3.5), MS_EVAL_BATCH (32768),
      MS_EVAL_STEPS (31), MS_TRAIN_STEPS (120), MS_TRAIN_BATCH (256),
      MS_DEVICE (cuda; cpu runs the plain version), MS_OUT.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.error_floor_campaign import (
    REGISTRY,
    relocate_registry,
)
from ldpc_sims_tpu_torch.examples.paired import count_errors, step_ms
from ldpc_sims_tpu_torch.ops.bp import freeze_minsum_weights
from ldpc_sims_tpu_torch.training import TrainConfig, train_minsum_weights
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["CODE", "GUARD_SNRS", "KEY", "main", "parity_vs_flooding20",
           "registry_copy", "run", "settings"]

GUARD_SNRS = (1.75, 2.25)
KEY = 42  # the paired frames' key
# the code the JAX script runs (run() takes any library QC code)
CODE = "wifi1944"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``MS_*`` variables."""
    env = os.environ.get
    return dict(
        ks=tuple(int(x) for x in env("MS_KS", "6,8").split(",")),
        train_snr=tuple(float(x) for x in
                        env("MS_TRAIN_SNR", "1.25,3.5").split(",")),
        batch=int(env("MS_EVAL_BATCH", "32768")),
        steps_per_point=int(env("MS_EVAL_STEPS", "31")),
        train_steps=int(env("MS_TRAIN_STEPS", "120")),
        train_batch=int(env("MS_TRAIN_BATCH", "256")),
        device=env("MS_DEVICE", "cuda"),
        out=env("MS_OUT", ""),
    )


def parity_vs_flooding20(ber: dict, flooding_ber: dict) -> bool:
    """A schedule's guard verdict: its BER at every guard point at most
    1.15 × flooding-20's + 5e-8 (``ber`` keyed by ``str(snr)``)."""
    return all(ber[str(s)] <= flooding_ber[str(s)] * 1.15 + 5e-8
               for s in GUARD_SNRS)


def registry_copy(reg: dict, code_name: str, schedules: dict) -> dict:
    """``reg`` with ``schedules`` ({K: entry}) merged into its layered
    schedules of ``code_name`` (the JAX script's ``node.update``), as a new
    dict."""
    reg = copy.deepcopy(reg)
    reg.setdefault(code_name, {}).setdefault("layered", {}).update(schedules)
    return reg


def run(dev, ks=(6, 8), train_snr=(1.25, 3.5), batch: int = 32768,
        steps_per_point: int = 31, train_steps: int = 120,
        train_batch: int = 256, code: str = CODE
        ) -> tuple[dict, dict]:
    """The guard's control, then each K trained, guarded and timed on
    ``dev``. Returns the record and the new registry entries ({str(K):
    entry})."""
    code = get_code(code)
    log(f"device {dev}, code {code.name}, Ks={tuple(ks)}")
    nbits = steps_per_point * batch * code.k

    def guard(kw: dict, tag: str) -> tuple[dict, dict]:
        ber, stats = {}, {}
        for snr in GUARD_SNRS:
            t0 = time.time()
            c = count_errors(code, kw, snr, steps_per_point, batch, KEY, dev,
                             info_bits=True)
            ber[str(snr)] = c.ber
            stats[str(snr)] = {"frame_errs": c.frame_errs,
                               "ber_se": c.ber_se}
            log(f"{tag} @{snr}: BER {c.ber:.3e} ({c.bit_errs} errs, "
                f"{c.frame_errs} frames, {time.time() - t0:.1f}s)")
        return ber, stats

    def timing(kw: dict, tag: str) -> dict:
        dt = step_ms(code, kw, batch, 7, dev) / 1e3
        rate = batch * code.k / dt
        log(f"{tag}: {dt * 1e3:.2f} ms/step, {rate:.3e} info bits/s")
        return {"ms_per_step": dt * 1e3, "info_bits_per_s": rate}

    out = {
        "what": (
            "Short trained layered schedules vs flooding-20 BER parity "
            f"on {code.name}, paired noise, {nbits:.1e} info bits per point."
        ),
        "train": {"snr_db": list(train_snr), "steps": train_steps,
                  "batch": train_batch},
        "guard_snrs": list(GUARD_SNRS),
        "device": str(dev),
        "arms": {},
    }
    flood = dict(iterations=20)
    fber, fstats = guard(flood, "flooding20")
    out["arms"]["flooding20"] = {"ber": fber, "stats": fstats,
                                 "timing": timing(flood, "flooding20")}
    schedules = {}
    for K in ks:
        t0 = time.time()
        ms, info = train_minsum_weights(
            code, TrainConfig(optimizer="adam", learning_rate=0.02, seed=K),
            iterations=K, schedule="layered", snr_db=tuple(train_snr),
            steps=train_steps, batch=train_batch, log=None, device=dev)
        alpha, beta = freeze_minsum_weights(ms)
        log(f"trained K={K} in {time.time() - t0:.0f}s "
            f"(BCE {info['loss'][0]:.4f}→{info['loss'][-1]:.4f})")
        kw = dict(iterations=K, schedule="layered", alpha=alpha, beta=beta)
        ber, stats = guard(kw, f"trained layered-{K}")
        arm = {"alpha": list(alpha), "beta": list(beta), "ber": ber,
               "stats": stats,
               "timing": timing(kw, f"trained layered-{K}")}
        arm["parity_vs_flooding20"] = parity_vs_flooding20(ber, fber)
        log(f"trained layered-{K} parity vs flooding-20: "
            f"{'OK' if arm['parity_vs_flooding20'] else 'FAIL'}")
        out["arms"][f"trained_layered{K}"] = arm
        schedules[str(K)] = {"alpha": list(alpha), "beta": list(beta),
                             "parity_ok": arm["parity_vs_flooding20"]}
    return out, schedules


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    out = cfg.pop("out")
    rec, schedules = run(dev, code=CODE, **cfg)
    path = out or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_minsum_short.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"record -> {path}")
    reg_out = os.path.splitext(path)[0] + "_schedules.json"
    with open(REGISTRY) as f:
        reg = relocate_registry(json.load(f), os.path.dirname(REGISTRY),
                                os.path.dirname(os.path.abspath(reg_out)))
    with open(reg_out, "w") as f:
        json.dump(registry_copy(reg, CODE, schedules), f, indent=1)
    print(reg_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
