"""Per-edge neural BP composed with the layered schedule at (1944,972)
(the port of the JAX package's ``examples/train_edge_layered_1944.py``).

1. Train edge-flavor weights for a layered-K min-sum decode by BCE through
   the differentiable roll backend (weighted serial-C sweeps), on
   all-zero-codeword BPSK batches at Es/N0 uniform in $EL_SNR a codeword
   (the wide window: the narrow one is what floored the α/β family),
   drawn on the device from a generator seeded with 11. Under $EL_JOINT
   (default) a per-iteration (α, β) schedule trains with them (the
   multiplicative per-edge family cannot express an offset): two adam
   parameter groups, ``ms_*`` at $EL_MS_LR and the edge weights at
   $EL_LR (``optax.multi_transform``). $EL_WARM: an ``.npz`` to continue
   from.
2. Every tenth of the run, a decoded-BER probe at 2.0, 2.5 and 3.0 dB
   ($EL_PROBE_BATCH frames each) through ``training.decoded_ber_probe``:
   a hard decode under ``no_grad``, on the card the ``_w`` kernel with the
   α/β table, where the JAX script decodes on roll under $EL_JOINT; the
   hard bits are the same, the kernels equal to the plain version bit for
   bit.
3. Decode on the kernels (``minsum_qc_layered_w`` on the card) on paired
   frames (key 55, every coded bit counted): flooding-20 (the control),
   plain layered-K, the trained layered-K and the registry's trained
   layered-8, $EL_EVAL_STEPS × $EL_EVAL_BATCH frames at 1.75 and 2.25 dB
   and $EL_FLOOR_STEPS at 2.75 and 3.25 dB; :func:`parity_verdict` gives
   the verdict a point against the control.
4. Time plain and trained layered-K as a pipe of 32 decodes of fresh
   ``N(0,1)·2 − 4`` LLRs with one synchronization, the median of 3
   (``bigcode.pipe_rate``).
5. Write the record to $EL_OUT (default
   ``outputs/<stamp>_edge_layered1944_K<K>.json``), the trained weights to
   ``<record>.npz`` beside it and a copy of the trained-schedule registry
   with the decoder as ``edge_layered.K`` (``weights_npz`` relative to the
   copy's directory) to ``<record>_schedules.json``; ``EF_REGISTRY=<copy>``
   runs the error-floor campaign on it. The committed registry and npz
   files are read, never written.

Run:  python -m ldpc_sims_tpu_torch.examples.train_edge_layered_1944
Env:  EL_K (6), EL_STEPS (1500), EL_BATCH (192), EL_LR (2e-3), EL_MS_LR
      (0.01), EL_JOINT (1), EL_SNR ("1.25,3.5"), EL_EVAL_BATCH (32768),
      EL_EVAL_STEPS (31), EL_FLOOR_STEPS (31), EL_PROBE_BATCH (16384),
      EL_WARM, EL_DEVICE (cuda; cpu runs the plain version), EL_OUT.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.bigcode import pipe_rate
from ldpc_sims_tpu_torch.examples.error_floor_campaign import (
    REGISTRY,
    relocate_registry,
)
from ldpc_sims_tpu_torch.examples.paired import count_errors
from ldpc_sims_tpu_torch.ops.bp import (
    freeze_minsum_weights,
    init_minsum_weights,
    init_neural_bp_weights,
    pack_decoder_weights,
)
from ldpc_sims_tpu_torch.parallel.mc import stable_seed
from ldpc_sims_tpu_torch.training import TrainConfig, decoded_ber_probe
from ldpc_sims_tpu_torch.training.trainer import minsum_batch, minsum_step
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["CODE", "FLOOR_SNRS", "GUARD_SNRS", "main", "optimizer",
           "parity_verdict", "registry_copy", "run", "settings",
           "train_step"]

GUARD_SNRS = (1.75, 2.25)
FLOOR_SNRS = (2.75, 3.25)
PROBE_SNRS = (2.0, 2.5, 3.0)
PIPE = 32  # decodes a timed pipe
TRAIN_KEY = 11  # the training frames' and the probes' key
KEY = 55  # the paired frames' key
# the code the JAX script runs (run() takes any library QC code)
CODE = "wifi1944"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``EL_*`` variables."""
    env = os.environ.get
    return dict(
        k=int(env("EL_K", "6")),
        steps=int(env("EL_STEPS", "1500")),
        batch=int(env("EL_BATCH", "192")),
        lr=float(env("EL_LR", "2e-3")),
        ms_lr=float(env("EL_MS_LR", "0.01")),
        joint=env("EL_JOINT", "1") == "1",
        snr=tuple(float(x) for x in env("EL_SNR", "1.25,3.5").split(",")),
        eval_batch=int(env("EL_EVAL_BATCH", "32768")),
        eval_steps=int(env("EL_EVAL_STEPS", "31")),
        floor_steps=int(env("EL_FLOOR_STEPS", "31")),
        probe_batch=int(env("EL_PROBE_BATCH", "16384")),
        warm=env("EL_WARM") or None,
        device=env("EL_DEVICE", "cuda"),
        out=env("EL_OUT", ""),
    )


def optimizer(weights: dict, lr: float, ms_lr: float
              ) -> torch.optim.Optimizer:
    """``optax.multi_transform`` of two adams: the ``ms_*`` arrays at
    ``ms_lr``, the edge weights at ``lr``, as two parameter groups."""
    groups = [{"params": [w for key, w in weights.items()
                          if key.startswith("ms_")], "lr": ms_lr},
              {"params": [w for key, w in weights.items()
                          if not key.startswith("ms_")], "lr": lr}]
    return TrainConfig(optimizer="adam").make_optimizer(
        [g for g in groups if g["params"]])


def train_step(weights: dict, opt, code, llr: torch.Tensor) -> torch.Tensor:
    """One step: the BCE of the soft layered-K min-sum decode with the
    weights (K their iterations) against the all-zero codeword, on the
    roll backend; returns the loss."""
    return minsum_step(weights, opt, code, llr,
                       iterations=weights["w_llr"].shape[0],
                       schedule="layered", backend="roll")


def parity_verdict(ctrl: dict, trained: dict) -> dict:
    """Per point (keys ``str(snr)``), whether the trained decoder's bit
    errors stay within the control's ``c``: at most 1.15·c + 5·√c + 20
    (each point a dict with ``errs``)."""
    out = {}
    for snr, c in ctrl.items():
        ce = c["errs"]
        out[snr] = bool(trained[snr]["errs"]
                        <= ce * 1.15 + 5.0 * math.sqrt(ce) + 20)
    return out


def registry_copy(reg: dict, code_name: str, k: int, entry: dict) -> dict:
    """``reg`` with ``entry`` as its ``edge_layered.k`` decoder of
    ``code_name``, as a new dict."""
    reg = copy.deepcopy(reg)
    reg.setdefault(code_name, {}).setdefault("edge_layered", {})[str(k)] = (
        entry)
    return reg


def run(dev, out: str, k: int = 6, steps: int = 1500, batch: int = 192,
        lr: float = 2e-3, ms_lr: float = 0.01, joint: bool = True,
        snr=(1.25, 3.5), eval_batch: int = 32768, eval_steps: int = 31,
        floor_steps: int = 31, probe_batch: int = 16384,
        warm: str | None = None, registry: str = REGISTRY,
        code: str = CODE) -> dict:
    """Training, the paired guard and the pipe timings on ``dev``; the
    record goes to ``out``, the weights to ``<out>.npz`` and the registry
    copy to ``<out>_schedules.json``. Returns the record."""
    name, code = code, get_code(code)  # the registry's key, the code
    log(f"device {dev}, code {name}, layered K={k}")
    init = init_neural_bp_weights(code, k, flavor="edge")
    if joint:
        init.update(init_minsum_weights(k))
    if warm:
        with np.load(warm) as z:
            init = {key: torch.from_numpy(z[key]) for key in init}
        log(f"warm start from {warm}")
    weights = {key: w.to(dev, torch.float32).requires_grad_()
               for key, w in init.items()}
    n_params = sum(w.numel() for w in weights.values())
    log(f"weights ({'joint' if joint else 'edge'}): {n_params} parameters")
    opt = optimizer(weights, lr, ms_lr)
    probe = decoded_ber_probe(code, PROBE_SNRS, batch=probe_batch,
                              device=dev, iterations=k, method="min-sum",
                              schedule="layered")
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_KEY)
    losses, probes = [], []
    t0 = time.time()
    for i in range(steps):
        llr = minsum_batch(gen, code, batch, snr[0], snr[1])
        losses.append(train_step(weights, opt, code, llr))
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            bers = probe(weights, stable_seed(TRAIN_KEY, 10**6 + i))
            probes.append({"step": i,
                           "ber": {str(s): v for s, v in bers.items()}})
            log(f"[{i + 1}/{steps}] BCE {float(losses[-1]):.5f} probe "
                + " ".join(f"{s}dB:{v:.2e}" for s, v in bers.items())
                + f" ({time.time() - t0:.0f}s)")
    losses = torch.stack(losses).tolist()
    weights = {key: w.detach() for key, w in weights.items()}

    with open(registry) as f:  # its .npz paths made relative to out's dir
        reg = relocate_registry(json.load(f), os.path.dirname(registry),
                                os.path.dirname(os.path.abspath(out)))
    t8 = reg.get(name, {}).get("layered", {}).get("8", {})
    edge = pack_decoder_weights(
        {key: w for key, w in weights.items() if key.startswith("w_")},
        code, k, dev)
    trained_kw = dict(iterations=k, schedule="layered", weights=edge)
    if joint:
        al_t, be_t = freeze_minsum_weights(weights)
        trained_kw.update(alpha=al_t, beta=be_t)
        log("frozen alpha: " + ",".join(f"{a:.3f}" for a in al_t))
        log("frozen beta:  " + ",".join(f"{b:.3f}" for b in be_t))
    configs = {
        "flooding-20": dict(iterations=20),
        f"layered-{k} plain": dict(iterations=k, schedule="layered"),
        f"layered-{k} per-edge": trained_kw,
    }
    if t8:
        configs["trained-layered-8"] = dict(
            iterations=8, schedule="layered",
            alpha=tuple(float(x) for x in t8["alpha"]),
            beta=tuple(float(x) for x in t8["beta"]))
    res_ber = {}
    for tag, kw in configs.items():
        res_ber[tag] = {}
        for snrs, n_steps in ((GUARD_SNRS, eval_steps),
                              (FLOOR_SNRS, floor_steps)):
            for snr_db in snrs:
                c = count_errors(code, kw, snr_db, n_steps, eval_batch, KEY,
                                 dev)
                res_ber[tag][str(snr_db)] = {
                    "ber": c.ber, "errs": c.bit_errs, "coded_bits": c.bits,
                    "frame_errs": c.frame_errs, "ber_se": c.ber_se}
                log(f"{tag} @{snr_db} dB: BER {c.ber:.3e} ({c.bit_errs} "
                    f"errs, {c.frame_errs} frames)")

    rates = {}
    for tag in (f"layered-{k} plain", f"layered-{k} per-edge"):
        r = pipe_rate(code, eval_batch, PIPE, device=dev, **configs[tag])
        rates[tag] = r["info_bits_per_s"]
        log(f"{tag}: {r['ms_per_step']:.2f} ms/step, "
            f"{r['info_bits_per_s']:.3e} bits/s")

    verdict = parity_verdict(res_ber["flooding-20"],
                             res_ber[f"layered-{k} per-edge"])
    for snr_db, ok in verdict.items():
        log(f"per-edge layered-{k} @{snr_db} dB: "
            f"{'OK' if ok else 'WORSE'}")
    stem = os.path.splitext(out)[0]
    npz = stem + ".npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(npz, **{key: w.cpu().numpy() for key, w in weights.items()})
    res = {
        "what": (
            f"per-edge neural-BP composed with the layered schedule at "
            f"{name}; trained on the roll backend, evaluated on the "
            "CUDA kernels"
        ),
        "K": k, "steps": steps, "batch": batch, "lr": lr,
        "train_snr_db": list(snr), "params": n_params,
        "bce": [losses[0], losses[-1]], "probes": probes,
        "ber": res_ber, "pipe_bits_per_s": rates,
        "parity_vs_flooding20": verdict,
        "weights_npz": os.path.basename(npz), "device": str(dev),
    }
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    log(f"record -> {out}")
    entry = {
        "weights_npz": os.path.basename(npz),
        "parity_ok": all(verdict.get(str(s), False) for s in GUARD_SNRS),
        "guard_verdict": verdict,
        "artifact": os.path.basename(out),
        # floor_ok is set only by the full error-floor campaign
    }
    if joint:
        entry.update(alpha=list(al_t), beta=list(be_t))
    reg_out = stem + "_schedules.json"
    with open(reg_out, "w") as f:
        json.dump(registry_copy(reg, name, k, entry), f, indent=1)
    log(f"registry copy: {reg_out}")
    return res


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    out = cfg.pop("out") or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_edge_layered1944_"
                   f"K{cfg['k']}.json")
    run(dev, out, registry=REGISTRY, code=CODE, **cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
