"""Joint (LLR net → BP) end-to-end training: the before/after BER record
(the port of the JAX package's ``examples/joint_before_after.py``).

The reference's joint experiment end to end: train an unquantized LLR
estimator at 5 dB, warm-start a quantized (3-bit ADC) one from it, graft
that into the ``Joint`` model (decoder weights all ones: classic BP on the
quantized net's LLRs), train it end to end with BCE on the transmitted
bits at 5 dB (two parameter groups, 5× the rate on the LLR net), and
record the coded BER on identical channel realizations (seed 99) before
and after the joint stage, beside classic BP on the analytic and on the
quantized LLRs (:func:`..diagnostics.evaluate_joint`).

Run:  python -m ldpc_sims_tpu_torch.examples.joint_before_after
Env:  JB_DEVICE (cuda; cpu runs the plain version), JB_OUT
      (outputs/<stamp>_joint_before_after.json). ``run()`` takes the
      sizes (8192 codewords and 30 epochs a LLR stage, 16384 codewords
      and 40 epochs of joint training, 16384 evaluation codewords).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.diagnostics import evaluate_joint
from ldpc_sims_tpu_torch.models import Joint, LLRestimator
from ldpc_sims_tpu_torch.ops.chain import LinkConfig
from ldpc_sims_tpu_torch.training import (
    TrainConfig,
    make_joint_dataset,
    make_llr_dataset,
    train_joint,
    train_llr,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["main", "run"]

SNRDB = 5.0  # the reference's joint operating point
QBITS = 3
BP_ITERS = 3  # the reference's evaluation depth
EVAL_GRID = (3.0, 4.0, 5.0, 6.0)


def run(dev, codewords: int = 8192, epochs: int = 30,
        joint_codewords: int = 16384, joint_epochs: int = 40,
        eval_codewords: int = 16384) -> dict:
    """The whole experiment on ``dev``; returns the record."""
    code = get_code("ref6432")
    clean = LinkConfig(bp_iterations=BP_ITERS, clamp=20.0)
    quant = LinkConfig(bp_iterations=BP_ITERS, clamp=20.0, qbits=QBITS)

    def gen(seed: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    # 1. the unquantized LLR net at 5 dB
    x, y = make_llr_dataset(gen(0), code, clean, codewords, snrdb=SNRDB)
    tc = TrainConfig(optimizer="adam", learning_rate=1e-3,
                     num_epochs=epochs, batch_size=1024, eval_every=10)
    unq, _ = train_llr(LLRestimator(ofdm_size=32), x, y, tc, log=None,
                       device=dev)
    print("unquantized LLR net trained", flush=True)

    # 2. the quantized net, warm-started from it
    xq, yq = make_llr_dataset(gen(1), code, quant, codewords, snrdb=SNRDB)
    qnet, _ = train_llr(LLRestimator(ofdm_size=32), xq, yq, tc,
                        init_params=unq.state_dict(), log=None, device=dev)
    print("quantized LLR net trained (warm start)", flush=True)

    # 3. the joint model with the quantized net grafted in and its decoder
    #    weights at their all-ones init: the BEFORE state
    model = Joint(code_name="ref6432", iterations=BP_ITERS, clamp=20.0)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model.LLRest.load_state_dict(qnet.state_dict())
    xj, bits = make_joint_dataset(gen(2), code, quant, joint_codewords,
                                  snrdb=SNRDB)
    before = evaluate_joint(model, None, code, quant, snrdb_grid=EVAL_GRID,
                            num_codewords=eval_codewords, seed=99, log=None,
                            device=dev)
    print("before:", ["%.3e" % b for b in before["ber_joint"]], flush=True)

    # 4. end-to-end BCE training at 5 dB (the committed recipe: adam 2e-5,
    #    gradient accumulation over minibatches of 512 symbols)
    tj = TrainConfig(optimizer="adam", learning_rate=2e-5,
                     num_epochs=joint_epochs, batch_size=2048,
                     minibatch_size=512, eval_every=10)
    model, info = train_joint(model, xj, bits, tj,
                              llr_warm_start=qnet.state_dict(), log=None,
                              device=dev)
    after = evaluate_joint(model, None, code, quant, snrdb_grid=EVAL_GRID,
                           num_codewords=eval_codewords, seed=99, log=None,
                           device=dev)
    print("after: ", ["%.3e" % b for b in after["ber_joint"]], flush=True)

    rec = {
        "what": ("joint (LLRnet->BP) end-to-end training, before/after "
                 "coded BER on identical channel realizations (seed 99)"),
        "config": {"code": "ref6432", "qbits": QBITS, "bp_iters": BP_ITERS,
                   "train_snrdb": SNRDB, "eval_codewords": eval_codewords,
                   "codewords": codewords, "epochs": epochs,
                   "joint_codewords": joint_codewords,
                   "joint_epochs": joint_epochs, "device": str(dev)},
        "snrdb": list(EVAL_GRID),
        "ber_joint_before": before["ber_joint"],
        "ber_joint_after": after["ber_joint"],
        "ber_classic": before["ber_classic"],
        "ber_quantized_llr": before["ber_quantized"],
        "bler_joint_before": before["bler_joint"],
        "bler_joint_after": after["bler_joint"],
        "train_loss_first_last": [float(info["train_loss"][0]),
                                  float(info["train_loss"][-1])],
    }
    i5 = list(EVAL_GRID).index(SNRDB)
    rec["improves_at_train_snr"] = bool(
        after["ber_joint"][i5] < before["ber_joint"][i5])
    return rec


def main() -> int:
    env = os.environ.get
    dev = resolve_device(env("JB_DEVICE", "cuda"))
    rec = run(dev)
    path = env("JB_OUT") or os.path.join(
        "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}"
                   "_joint_before_after.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"record -> {path}")
    i5 = list(EVAL_GRID).index(SNRDB)
    print(f"BER at {SNRDB} dB: {rec['ber_joint_before'][i5]:.3e} -> "
          f"{rec['ber_joint_after'][i5]:.3e} ("
          f"{'improved' if rec['improves_at_train_snr'] else 'NOT improved'}"
          ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
