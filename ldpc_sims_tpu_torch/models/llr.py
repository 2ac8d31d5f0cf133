"""Neural LLR estimators as ``torch.nn.Module``s (the port of
``models/llr.py``).

MLPs that regress exact per-bit LLRs from (possibly coarsely quantized)
time-domain OFDM samples, one OFDM symbol a row:

* :class:`LLRestimator` — fixed-SNR model: a bias-free linear
  ``fft_layer`` initialised to the block DFT, 3 tanh layers of width
  8·2N (``hidden3..5``), a linear ``final`` of 2N LLRs.
* :class:`LLRestimatorWithSNR` — input 2N samples ⊕ the linear SNR, 3
  tanh layers of 8·2N (``hidden1..3``), linear ``final``.
* :class:`LLRestimatorTanh` — as the SNR model, with a tanh on the
  output (trained against ``tanh(llr)``; the evaluator inverts it).

The input layout is the JAX package's block form ``concat(re, im)`` per
OFDM symbol. Submodule names are flax's, so a state-dict key
(``hidden3.weight``) reads like the flax path (``hidden3/kernel``);
``convert.llr_state_dict_from_flax`` carries a flax param tree across
(a flax ``kernel`` (in, out) is a torch ``weight`` (out, in)).

A fresh module draws as flax's ``Dense`` does: a lecun-normal kernel
(a normal truncated to ±2 standard deviations, scaled so the variance is
1/fan_in) and a zero bias, from the ``generator`` given (or the global
one). The products are plain ``nn.Linear`` layers, as the JAX package
computes them outside any kernel; they run in float32 with TF32 off
(PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``,
which nothing in the port changes).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["LLRestimator", "LLRestimatorWithSNR", "LLRestimatorTanh",
           "block_dft"]

# stddev of a standard normal truncated to (-2, 2): flax's variance_scaling
# divides by it so the truncated draw keeps the asked-for variance
_TRUNC_STD = 0.87962566103423978


def block_dft(n: int) -> np.ndarray:
    """Real 2N×2N matrix computing the unitary DFT on concat(re, im):
    ``[[Re W, −Im W], [Im W, Re W]]``, W the unitary DFT matrix (JAX
    ``models/llr.py:_block_dft``)."""
    k = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)
    top = np.concatenate([W.real, -W.imag], axis=1)
    bot = np.concatenate([W.imag, W.real], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.float32)


def _lecun_normal_(linear: nn.Linear, generator) -> None:
    """flax ``Dense``'s default init: lecun-normal kernel, zero bias."""
    std = (1.0 / linear.in_features) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if linear.bias is not None:
            linear.bias.zero_()


class _Estimator(nn.Module):
    """The three estimators' shared body; each subclass sets what differs:
    the DFT front layer, the SNR feature, the hidden layers' first index
    and the tanh on the output."""

    _fft_front = False
    _snr_feature = True
    _first_hidden = 1
    _tanh_out = False

    def __init__(self, ofdm_size: int = 32, generator=None, device=None):
        super().__init__()
        self.ofdm_size = ofdm_size
        n2 = 2 * ofdm_size
        if self._fft_front:
            self.fft_layer = nn.Linear(n2, n2, bias=False, device=device)
        width = n2 + (1 if self._snr_feature else 0)
        self._hidden = [f"hidden{i + self._first_hidden}" for i in range(3)]
        for name in self._hidden:
            setattr(self, name, nn.Linear(width, 8 * n2, device=device))
            width = 8 * n2
        self.final = nn.Linear(width, n2, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        """A fresh draw: the block DFT in ``fft_layer``, flax's ``Dense``
        defaults everywhere else, in the order flax initialises them."""
        if self._fft_front:
            with torch.no_grad():
                self.fft_layer.weight.copy_(torch.from_numpy(
                    block_dft(self.ofdm_size)))
        for name in self._hidden:
            _lecun_normal_(getattr(self, name), generator)
        _lecun_normal_(self.final, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fft_front:
            x = self.fft_layer(x)
        for name in self._hidden:
            x = torch.tanh(getattr(self, name)(x))
        x = self.final(x)
        return torch.tanh(x) if self._tanh_out else x


class LLRestimator(_Estimator):
    """Fixed-SNR LLR estimator: trainable DFT layer + 3×16N tanh MLP."""

    _fft_front = True
    _snr_feature = False
    _first_hidden = 3


class LLRestimatorWithSNR(_Estimator):
    """SNR-conditioned estimator: input (2N samples ⊕ linear SNR)."""


class LLRestimatorTanh(_Estimator):
    """SNR-conditioned estimator with tanh-squashed outputs; the evaluator
    inverts them (:func:`ldpc_sims_tpu_torch.evaluate.invert_tanh`)."""

    _tanh_out = True
