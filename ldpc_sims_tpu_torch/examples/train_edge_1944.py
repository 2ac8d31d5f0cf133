"""Per-edge neural BP at scale: train on (1944,972), decode on the kernels
(the port of the JAX package's ``examples/train_edge_1944.py``).

1. Train edge-flavor weights (``w_msg``/``w_llr`` an iteration and the
   final marginalization) for a short flooding-K min-sum decode by BCE
   through the differentiable roll backend (adam at $EDGE_LR), on
   all-zero-codeword BPSK batches at Es/N0 uniform in $EDGE_SNR a
   codeword, drawn on the device from a generator seeded with 4.
2. Decode the trained weights on the kernels (``minsum_qc_flooding_w`` on
   the card, the tables packed once) on paired frames (key 99,
   $EDGE_EVAL_STEPS × 32768 frames a point, every coded bit counted)
   beside plain flooding-K and flooding-20 at 1.75 and 2.25 dB.
3. Write the record (the JAX script's keys, plus ``stats``: each point's
   frames in error and the BER's standard error from the per-frame
   counts) to $EDGE_OUT, default ``outputs/<stamp>_edge1944.json``.

Run:  python -m ldpc_sims_tpu_torch.examples.train_edge_1944
Env:  EDGE_K (12), EDGE_STEPS (300), EDGE_BATCH (192), EDGE_SNR
      ("1.25,3.0"), EDGE_EVAL_STEPS (31), EDGE_LR (0.003), EDGE_DEVICE
      (cuda; cpu runs the plain version), EDGE_OUT.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.paired import count_errors
from ldpc_sims_tpu_torch.ops.bp import (
    init_neural_bp_weights,
    pack_decoder_weights,
)
from ldpc_sims_tpu_torch.training import TrainConfig
from ldpc_sims_tpu_torch.training.trainer import minsum_batch, minsum_step
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["CODE", "EVAL_BATCH", "GUARD_SNRS", "main", "optimizer", "run",
           "settings", "train_step"]

EVAL_BATCH = 32768
GUARD_SNRS = (1.75, 2.25)
TRAIN_KEY = 4  # the training frames' key
KEY = 99  # the paired frames' key
# the code the JAX script runs (run() takes any library QC code)
CODE = "wifi1944"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``EDGE_*`` variables."""
    env = os.environ.get
    return dict(
        k=int(env("EDGE_K", "12")),
        steps=int(env("EDGE_STEPS", "300")),
        batch=int(env("EDGE_BATCH", "192")),
        snr=tuple(float(x) for x in env("EDGE_SNR", "1.25,3.0").split(",")),
        eval_steps=int(env("EDGE_EVAL_STEPS", "31")),
        lr=float(env("EDGE_LR", "0.003")),
        device=env("EDGE_DEVICE", "cuda"),
        out=env("EDGE_OUT", ""),
    )


def optimizer(weights: dict, lr: float) -> torch.optim.Optimizer:
    """``optax.adam(lr)`` over the edge weights."""
    return TrainConfig(optimizer="adam", learning_rate=lr).make_optimizer(
        weights.values())


def train_step(weights: dict, opt, code, llr: torch.Tensor) -> torch.Tensor:
    """One step: the BCE of the soft flooding-K min-sum decode with the
    edge weights (K their iterations) against the all-zero codeword, on
    the roll backend; returns the loss."""
    return minsum_step(weights, opt, code, llr,
                       iterations=weights["w_llr"].shape[0], backend="roll")


def run(dev, k: int = 12, steps: int = 300, batch: int = 192,
        snr=(1.25, 3.0), eval_steps: int = 31, lr: float = 0.003,
        eval_batch: int = EVAL_BATCH, code: str = CODE
        ) -> tuple[dict, dict]:
    """Training, then the paired guard on ``dev``. Returns the record and
    the trained weights (detached tensors on ``dev``)."""
    code = get_code(code)
    log(f"device {dev}, code {code.name}, K={k}")
    weights = {key: w.to(dev).requires_grad_()
               for key, w in init_neural_bp_weights(code, k, "edge").items()}
    n_params = sum(w.numel() for w in weights.values())
    log(f"edge-flavor weights: {n_params} parameters")
    opt = optimizer(weights, lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_KEY)
    losses = []
    t0 = time.time()
    for i in range(steps):
        llr = minsum_batch(gen, code, batch, snr[0], snr[1])
        losses.append(train_step(weights, opt, code, llr))
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            log(f"[{i + 1}/{steps}] BCE {float(losses[-1]):.5f} "
                f"({time.time() - t0:.0f}s)")
    losses = torch.stack(losses).tolist()
    weights = {key: w.detach() for key, w in weights.items()}
    packed = pack_decoder_weights(weights, code, k, dev)

    def ber(tag: str, **kw) -> tuple[dict, dict]:
        out, stats = {}, {}
        for snr_db in GUARD_SNRS:
            c = count_errors(code, kw, snr_db, eval_steps, eval_batch, KEY,
                             dev)
            out[str(snr_db)] = c.ber
            stats[str(snr_db)] = {"frame_errs": c.frame_errs,
                                  "ber_se": c.ber_se}
            log(f"{tag} @{snr_db} dB: BER {c.ber:.3e} ({c.frame_errs} "
                "frames)")
        return out, stats

    arms = {f"flooding-{k} plain": dict(iterations=k),
            f"flooding-{k} per-edge": dict(iterations=k, weights=packed),
            "flooding-20 plain": dict(iterations=20)}
    bers, stats = {}, {}
    for tag, kw in arms.items():
        bers[tag], stats[tag] = ber(tag, **kw)
    return {
        "what": (
            f"per-edge neural-BP trained at {code.name} scale, evaluated "
            "on the CUDA kernels; paired noise"
        ),
        "K": k, "steps": steps, "batch": batch,
        "train_snr_db": list(snr), "params": n_params,
        "bce": [losses[0], losses[-1]],
        "ber": bers, "stats": stats, "device": str(dev),
    }, weights


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    out = cfg.pop("out")
    res, _ = run(dev, eval_batch=EVAL_BATCH, code=CODE, **cfg)
    path = out or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_edge1944.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"record -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
