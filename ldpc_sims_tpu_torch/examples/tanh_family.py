"""The tanh estimator family end to end: train, evaluate, compare (the port
of the JAX package's ``examples/tanh_family.py``).

The reference's tanh recipe, working:

1. one quantized-ADC data configuration ($TANH_QBITS bits, per-symbol
   random SNR in [$TANH_SNR_LO, $TANH_SNR_HI] dB, per-symbol AGC, the
   (64,32) reference chain) gives paired training sets, plain-LLR targets
   and tanh(LLR) targets, from one generator seed (20260821);
2. ``LLRestimatorWithSNR`` trains on the plain targets (weighted MSE, SGD
   at $TANH_LR_PLAIN), ``LLRestimatorTanh`` on the squashed ones (SGD at
   $TANH_LR_TANH: weighted MSE's 1/(|target|+ε) weights blow up adam at
   these scales);
3. both evaluate on identical noise (``evaluate_sweep`` with seed 11):
   coded BER through BP (sum-product-ref-3, clamp 20), WMSE, and for the
   tanh model the flipped-position WMSE after the atanh inversion. The
   columns that do not depend on the estimator are equal in both arms;
4. the comparison goes to ``$TANH_OUT/<stamp>_tanh_family.json``, each
   arm's checkpoint under ``$TANH_OUT/model/`` and a ``tanh-family``
   record per arm into ``$TANH_OUT/registry.jsonl``.

Run:  python -m ldpc_sims_tpu_torch.examples.tanh_family
Env:  TANH_QBITS (3), TANH_SNR_LO (0), TANH_SNR_HI (10), TANH_NUM_CW
      (16384), TANH_EPOCHS (600), TANH_OUT (outputs), TANH_LR_PLAIN
      (0.02), TANH_LR_TANH (0.005), TANH_DEVICE (cuda; cpu runs the plain
      version).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
from ldpc_sims_tpu_torch.models import LLRestimatorTanh, LLRestimatorWithSNR
from ldpc_sims_tpu_torch.ops.chain import LinkConfig
from ldpc_sims_tpu_torch.training import (
    TrainConfig,
    make_llr_dataset,
    train_llr,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device
from ldpc_sims_tpu_torch.utils.registry import record_run

__all__ = ["SHARED_COLUMNS", "main", "run", "settings"]

# the data generator's seed (the JAX script's key)
SEED = 20260821
# the columns both arms share: they do not depend on the estimator
SHARED_COLUMNS = ("snrdb", "uncoded_ber", "coded_ber", "coded_bler",
                  "coded_ber_qllr", "coded_bler_qllr", "wmse_qllr")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's configuration from its ``TANH_*`` variables."""
    env = os.environ.get
    return dict(
        qbits=int(env("TANH_QBITS", "3")),
        snr_lo=float(env("TANH_SNR_LO", "0")),
        snr_hi=float(env("TANH_SNR_HI", "10")),
        num_cw=int(env("TANH_NUM_CW", "16384")),
        epochs=int(env("TANH_EPOCHS", "600")),
        out=env("TANH_OUT", "outputs"),
        lr_plain=float(env("TANH_LR_PLAIN", "0.02")),
        lr_tanh=float(env("TANH_LR_TANH", "0.005")),
        device=env("TANH_DEVICE", "cuda"),
    )


def run(dev, out: str, qbits: int = 3, snr_lo: float = 0.0,
        snr_hi: float = 10.0, num_cw: int = 16384, epochs: int = 600,
        lr_plain: float = 0.02, lr_tanh: float = 0.005,
        eval_codewords: int = 4096, stamp: str | None = None) -> dict:
    """Both arms on ``dev``, their checkpoints and registry records under
    ``out``; returns the record."""
    code = get_code("ref6432")
    link = LinkConfig(
        bp_iterations=3, bp_method="sum-product-ref", clamp=20.0,
        qbits=qbits, snr_per_symbol=True, snrdb_low=snr_lo,
        snrdb_high=snr_hi, agc="per-symbol",
    )
    stamp = stamp or time.strftime("%Y%m%d-%H%M%S")
    arms = {}
    for tag, tanh, model in (
        ("plain", False, LLRestimatorWithSNR(32)),
        ("tanh", True, LLRestimatorTanh(32)),
    ):
        tc = TrainConfig(learning_rate=lr_tanh if tanh else lr_plain,
                         num_epochs=epochs, batch_size=512, seed=3,
                         optimizer="sgd")
        t0 = time.time()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)  # both arms' data from the same draw
        x, y = make_llr_dataset(gen, code, link, num_cw,
                                with_snr_feature=True, tanh_targets=tanh)
        ckpt = os.path.join(out, "model", f"{stamp}_{tag}_q{qbits}")
        model, info = train_llr(
            model, x, y, tc, ckpt_dir=ckpt,
            manifest={"model": type(model).__name__, "tanh": tanh,
                      "qbits": qbits, "code": code.name},
            log=None, device=dev,
        )
        tl = [float(v) for v in info["train_loss"]]
        log(f"{tag}: trained {epochs} epochs in {time.time() - t0:.0f}s "
            f"(loss {tl[0]:.4f} -> {tl[-1]:.4f})")
        curves = evaluate_sweep(
            code, link,
            EvalConfig(snrdb=tuple(float(s) for s in range(0, 11, 2)),
                       num_codewords=eval_codewords, with_snr_feature=True,
                       tanh_model=tanh, seed=11),
            model=model, log=log, device=dev,
        )
        arms[tag] = {"model": type(model).__name__,
                     "final_train_loss": tl[-1], "ckpt": ckpt,
                     "curves": curves}
        record_run("tanh-family", out, arm=tag, ckpt=ckpt, qbits=qbits,
                   code=code.name)
    return {
        "what": (
            "tanh-target vs plain-target LLR estimator family on the "
            "quantized (64,32) chain: the reference's broken "
            "train_nn_tanh recipe, working (SURVEY 2.3); identical "
            "noise, flipped-WMSE metric for the tanh arm"
        ),
        "qbits": qbits, "snr_db": [snr_lo, snr_hi],
        "num_codewords": num_cw, "epochs": epochs, "device": str(dev),
        "arms": arms,
    }


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg.pop("device"))
    stamp = time.strftime("%Y%m%d-%H%M%S")
    rec = run(dev, stamp=stamp, **cfg)
    path = os.path.join(cfg["out"], f"{stamp}_tanh_family.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"record -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
