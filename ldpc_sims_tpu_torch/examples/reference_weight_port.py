"""Evaluate the reference's *stored* NN checkpoints on the port's chain (the
port of the JAX package's ``examples/reference_weight_port.py``).

The strongest end-to-end parity check available: take the per-SNR
quantized LLR-estimator weights the reference trained in 2019 (the 11
checkpoints named in its results registry
``outputs/results/20191203-191640_tx=20191203-162534_quantized.pkl`` —
the models behind BASELINE.md table A's ``coded_ber_nn`` column), load
them into the port's :class:`..models.LLRestimator` and run
:func:`..evaluate.evaluate_sweep` on the card. If the NN coded-BER curve
lands on table A, the whole chain — TX, AWGN, the global-AGC 3-bit
quantizer, NN inference, 3-iteration sum-product BP, the BER bookkeeping
— behaves as the reference's.

Weight port (cited to the reference):

* Architecture map (``nn/llr.py:7-52``): ``fft_layer`` (64×64 linear, no
  bias) → tanh(``hidden3``) → tanh(``hidden4``) → tanh(``hidden5``) →
  ``final``, the same ``nn.Linear`` layers as the port's module; the
  constructed-but-unused ``hidden1``/``hidden2``/``scalar`` parameters
  are dropped, and a ``DataParallel`` checkpoint's ``module.`` prefix.
* Input layout: the reference feeds **interleaved** re/im samples
  (``[re0, im0, re1, im1, ...]``, ``evaluate_quantized.py:100-101``); the
  port's chain feeds the block layout ``[re*, im*]``, so ``fft_layer``'s
  input columns are permuted from interleaved to block (an exactly
  equivalent function).
* Output layout: the codeword's 64 coded bits in natural order on both
  sides — no output permutation.

Run (needs the reference snapshot: ``LDPC_REFERENCE`` names its
``pytorch`` directory, by default ``reference/pytorch`` in the checkout):

    python -m ldpc_sims_tpu_torch.examples.reference_weight_port \\
        [--batch 65536] [--iters 3] [--qbits 3] [--seed 0] [--out FILE] \\
        [--device cuda]

The record goes to ``--out`` (``outputs/reference_weight_port.json``),
never under ``docs/artifacts/``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
from ldpc_sims_tpu_torch.models import LLRestimator
from ldpc_sims_tpu_torch.ops.chain import LinkConfig
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["block_index", "load_reference_params", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference snapshot's pytorch directory, unless LDPC_REFERENCE names it
REF = os.path.join(ROOT, "reference", "pytorch")
REGISTRY = "20191203-191640_tx=20191203-162534_quantized.pkl"


def block_index(ofdm_size: int) -> np.ndarray:
    """For each block position b of ``[re*, im*]``, its interleaved index
    (re of sample b at 2b, im of sample b − N at 2(b − N) + 1)."""
    n = ofdm_size
    return np.array([2 * b if b < n else 2 * (b - n) + 1
                     for b in range(2 * n)])


def load_reference_params(pth_path: str, ofdm_size: int,
                          template: LLRestimator) -> LLRestimator:
    """Load a reference LLRestimator checkpoint (its ``model_state_dict``)
    into ``template``, the port's module of that OFDM size, and return
    it."""
    ck = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = {k.removeprefix("module."): v.detach().to(torch.float32)
          for k, v in ck["model_state_dict"].items()}
    idx = torch.from_numpy(block_index(ofdm_size))
    state = {"fft_layer.weight": sd["fft_layer.weight"][:, idx]}
    for name in ("hidden3", "hidden4", "hidden5", "final"):
        state[f"{name}.weight"] = sd[f"{name}.weight"]
        state[f"{name}.bias"] = sd[f"{name}.bias"]
    with torch.no_grad():
        for key, value in template.state_dict().items():
            value.copy_(state[key])
    return template


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--qbits", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/reference_weight_port.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ref = os.environ.get("LDPC_REFERENCE", REF)
    reg_path = os.path.join(ref, "outputs", "results", REGISTRY)
    if not os.path.isfile(reg_path):
        sys.exit(f"reference registry not found: {reg_path}")
    with open(reg_path, "rb") as f:
        reg = pickle.load(f)

    dev = resolve_device(args.device)
    code = get_code("ref6432")
    model = LLRestimator(32, device=dev)
    # the stored curve's eval config (evaluate_quantized.py:14-24):
    # qbits=3, clip_ratio=1 (clipdb=0), 3-iter BP, clamp 20
    link = LinkConfig(
        ofdm_size=32, bp_iterations=args.iters,
        bp_method="sum-product-ref", clamp=20.0,
        qbits=args.qbits, clip_ratio=1.0,
    )

    curves: dict[str, list] = {"snrdb": [], "coded_ber_nn": [],
                               "coded_bler_nn": [], "wmse_nn": [],
                               "coded_ber": [], "coded_ber_qllr": []}
    for snrdb, fname in zip(reg["snrdb"], reg["filenames"]):
        load_reference_params(
            os.path.join(ref, "outputs", "model", fname), 32, model)
        ec = EvalConfig(snrdb=(float(snrdb),), num_codewords=args.batch,
                        seed=args.seed)
        c = evaluate_sweep(code, link, ec, model=model, log=None,
                           device=dev)
        for k in curves:
            curves[k].append(c[k][0] if k != "snrdb" else float(snrdb))
        print(
            f"snr={snrdb:5.1f}  nn={c['coded_ber_nn'][0]:.3e}  "
            f"wmse={c['wmse_nn'][0]:.3f}  trad={c['coded_ber'][0]:.3e}",
            flush=True,
        )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"source": "reference checkpoints (weight port)",
                   "registry": REGISTRY, "num_codewords": args.batch,
                   "device": str(dev), **curves}, f, indent=1)
    print(f"curves -> {args.out}")


if __name__ == "__main__":
    main()
