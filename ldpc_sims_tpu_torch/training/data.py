"""Training sets for the neural LLR and joint experiments (the port of
``training/data.py``).

One call of :func:`..ops.chain.link_step` with ``return_arrays=True``
gives the (input_samples, output_samples) pairs:

* inputs: the time-domain samples of each OFDM symbol as a row
  ``concat(re, im)``, from the quantized signal when ``cfg.qbits`` is set,
  optionally ⊕ the symbol's linear SNR (the random-SNR family);
* targets: the clean analytic LLRs of the ideal ADC, or the transmitted
  coded bits for the joint model.

The channel is drawn from the ``torch.Generator`` given, on its device;
the arrays come back as NumPy, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step

__all__ = ["make_llr_dataset", "make_joint_dataset"]


def _symbol_inputs(time_signal: torch.Tensor) -> torch.Tensor:
    """(rows, n_ofdm, N) complex → (rows·n_ofdm, 2N) concat(re, im)."""
    flat = time_signal.reshape(-1, time_signal.shape[-1])
    return torch.cat([flat.real, flat.imag], dim=1)


def _link_arrays(gen, code, cfg, num_codewords, snrdb) -> dict:
    with torch.no_grad():
        return link_step(gen, snrdb, code, cfg, num_codewords,
                         return_arrays=True)


def make_llr_dataset(
    gen: torch.Generator,
    code: LdpcCode,
    cfg: LinkConfig,
    num_codewords: int,
    snrdb: float = 0.0,
    with_snr_feature: bool = False,
    tanh_targets: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(input_samples, output_samples) as NumPy float32 arrays.

    ``cfg`` selects the channel: ``qbits`` for the quantized ADC,
    ``snr_per_symbol`` with ``snrdb_low/high`` for the random-SNR family;
    ``snrdb`` is the fixed SNR otherwise. ``with_snr_feature`` appends each
    OFDM symbol's linear SNR as a last column; ``tanh_targets`` regresses
    onto tanh(LLR) (the tanh estimator's recipe).
    """
    out = _link_arrays(gen, code, cfg, num_codewords, snrdb)
    sig = out["q_time"] if cfg.qbits is not None else out["rx_time"]
    x = _symbol_inputs(sig)
    if with_snr_feature:
        x = torch.cat([x, out["snr_sym"].reshape(-1, 1)], dim=1)
    y = out["llrs"].reshape(x.shape[0], -1)  # (S, 2N) clean LLR targets
    if tanh_targets:
        y = torch.tanh(y)
    return x.cpu().numpy(), y.cpu().numpy()


def make_joint_dataset(
    gen: torch.Generator,
    code: LdpcCode,
    cfg: LinkConfig,
    num_codewords: int,
    snrdb: float = 5.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Inputs for the joint model and the transmitted coded bits (int8,
    (num_codewords, n)) as its BCE targets: a fixed SNR, the quantized
    input when ``cfg.qbits`` is set."""
    out = _link_arrays(gen, code, cfg, num_codewords, snrdb)
    sig = out["q_time"] if cfg.qbits is not None else out["rx_time"]
    return (_symbol_inputs(sig).cpu().numpy(),
            out["coded"].cpu().numpy())
