"""The reference's core experiment end to end, small scale (the port of the
JAX package's ``examples/quantized_llr_study.py``).

Train an MLP to regress exact LLRs from coarsely quantized (3-bit ADC,
per-symbol AGC) time-domain OFDM samples, then compare three receivers on
identical bits:

* Traditional: analytic LLRs from the clean signal + BP,
* Quantized: analytic LLRs computed from the quantized signal + BP,
* NN: the trained LLR net on the quantized samples + BP,

through ``evaluate_sweep`` (sum-product-ref-3, clamp 20, 4096 codewords a
point, 0-10 dB), and draw the BER and WMSE figures. The figures need
matplotlib: :func:`main` stops before it draws any data when it is absent
(the card's machine has none); :func:`run` returns the curves without
drawing.

Run:  python -m ldpc_sims_tpu_torch.examples.quantized_llr_study
      (``main(num_codewords, epochs, snrdb_train, qbits, out_prefix,
      device)``; the figures go to ``<out_prefix>_ber.png`` and
      ``_wmse.png``, default ``outputs/quantized_llr_study``; ``device``
      'cuda', or 'cpu' for the plain version). At 4096 codewords and 300
      epochs (SGD at 0.02) the NN receiver's coded BER at the 5 dB
      training point is ≈ 4.5e-2, the JAX script's measured checkpoint.
"""

from __future__ import annotations

import os
import types

import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
from ldpc_sims_tpu_torch.models import LLRestimator
from ldpc_sims_tpu_torch.ops.chain import LinkConfig
from ldpc_sims_tpu_torch.training import (
    TrainConfig,
    make_llr_dataset,
    train_llr,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["main", "run"]

EVAL_SNRS = tuple(float(s) for s in range(0, 11, 2))


def run(dev, num_codewords: int = 8192, epochs: int = 1000,
        snrdb_train: float = 5.0, qbits: int = 3,
        eval_codewords: int = 4096) -> dict:
    """Train on ``dev`` and evaluate the three receivers; returns the
    curves (``evaluate_sweep``'s dict)."""
    code = get_code("ref6432")
    # per-symbol AGC quantization (the quantized_snr.py recipe; its fixed
    # agc_clip keeps the reference's legacy clip bound benign)
    link_train = LinkConfig(bp_iterations=1, qbits=qbits, agc="per-symbol",
                            agc_clip=10.0)
    print(f"generating {num_codewords} codewords @ {snrdb_train} dB ...",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x, y = make_llr_dataset(gen, code, link_train, num_codewords,
                            snrdb=snrdb_train)
    print("training LLR estimator on quantized inputs ...", flush=True)
    model, _ = train_llr(
        LLRestimator(ofdm_size=32), x, y,
        TrainConfig(learning_rate=0.02, num_epochs=epochs, batch_size=1024),
        device=dev)
    link_eval = LinkConfig(
        bp_iterations=3, bp_method="sum-product-ref", clamp=20.0,
        qbits=qbits, agc="per-symbol", agc_clip=10.0)
    print("evaluating Traditional / Quantized / NN curves ...", flush=True)
    return evaluate_sweep(
        code, link_eval,
        EvalConfig(snrdb=EVAL_SNRS, num_codewords=eval_codewords),
        model=model, device=dev)


def main(num_codewords: int = 8192, epochs: int = 1000,
         snrdb_train: float = 5.0, qbits: int = 3,
         out_prefix: str = "outputs/quantized_llr_study",
         device="cuda") -> dict:
    """The study with its figures; returns the curves. Without matplotlib
    it stops before any data is drawn (``SystemExit``)."""
    from ldpc_sims_tpu_torch.cli.main import _need_matplotlib
    from ldpc_sims_tpu_torch.plotting import plot_ber_curves, plot_wmse

    dev = resolve_device(device)
    _need_matplotlib(types.SimpleNamespace(plot=True))
    curves = run(dev, num_codewords, epochs, snrdb_train, qbits)
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    ber_png = plot_ber_curves(curves, f"{out_prefix}_ber.png",
                              title=f"(64,32) QPSK/OFDM, {qbits}-bit ADC")
    wmse_png = plot_wmse(curves, f"{out_prefix}_wmse.png")
    print(f"figures: {ber_png}  {wmse_png}")
    return curves


if __name__ == "__main__":
    main()
