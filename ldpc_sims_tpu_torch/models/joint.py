"""The joint model: a neural LLR estimator feeding a differentiable BP
decoder (the port of ``models/joint.py``).

One ``nn.Module`` whose parameters are the estimator's (the submodule
``LLRest``) and, with ``trainable_bp``, four per-iteration neural-BP
weight arrays ``bp_w_msg``/``bp_w_llr``/``bp_w_msg_final``/
``bp_w_llr_final``, so BCE gradients on the decoded bits reach both.
The names are flax's, so :func:`..convert.joint_params_to_flax` and
:func:`..convert.joint_state_dict_from_flax` carry the tree across.
"""

from __future__ import annotations

import torch
from torch import nn

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.models.llr import LLRestimator, LLRestimatorWithSNR
from ldpc_sims_tpu_torch.ops.bp import bp_decode

__all__ = ["Joint"]

# the decoder's weight names in bp_decode's dict → the module's parameters
_BP_WEIGHTS = {"w_msg": "bp_w_msg", "w_llr": "bp_w_llr",
               "w_msg_final": "bp_w_msg_final",
               "w_llr_final": "bp_w_llr_final"}


class Joint(nn.Module):
    """signal (per-OFDM-symbol inputs) → Pr(bit=1) per codeword bit.

    Args:
      code_name: registry name of the LDPC code.
      ofdm_size: subcarriers per OFDM symbol.
      iterations: unrolled BP iterations.
      method: BP check rule ('sum-product' for smooth gradients).
      clamp: per-iteration message clamp.
      snr_conditioned: use the SNR-conditioned estimator (input 2N+1).
      trainable_bp: include the per-iteration neural-BP weights, all ones
        at first (plain BP), shaped as JAX's: (iterations, n, dv),
        (iterations, n), (n, dv), (n,).
      generator: the estimator's init draw (flax ``Dense``'s defaults).

    Input: (num_symbols, 2N[+1]); 2N·num_symbols must tile the codeword
    length. Output: (num_codewords, n) soft bits, the sigmoid of half the
    posterior LLR, from ``bp_decode(..., output='soft')``. The decode is
    the plain PyTorch one whenever a gradient is needed (``auto`` takes
    the roll backend for a QC code), and the kernels under
    ``torch.no_grad()`` on the card. A non-QC code such as ref6432 decodes
    on the gather backend, where JAX's ``auto`` takes its dense backend
    (m·dc ≤ 1024): the same function up to the order of the sums.
    """

    def __init__(self, code_name: str = "ref6432", ofdm_size: int = 32,
                 iterations: int = 3, method: str = "sum-product",
                 clamp: float | None = 20.0, snr_conditioned: bool = False,
                 trainable_bp: bool = True, generator=None, device=None):
        super().__init__()
        self.code = get_code(code_name)
        self.iterations = iterations
        self.method = method
        self.clamp = clamp
        self.trainable_bp = trainable_bp
        est_cls = LLRestimatorWithSNR if snr_conditioned else LLRestimator
        self.LLRest = est_cls(ofdm_size, generator=generator, device=device)
        if trainable_bp:
            g = self.code.graph
            shapes = {"bp_w_msg": (iterations, g.n_vars, g.dv),
                      "bp_w_llr": (iterations, g.n_vars),
                      "bp_w_msg_final": (g.n_vars, g.dv),
                      "bp_w_llr_final": (g.n_vars,)}
            for name, shape in shapes.items():
                self.register_parameter(
                    name, nn.Parameter(torch.ones(shape, device=device)))

    def reset_parameters(self, generator=None) -> None:
        """A fresh draw of the estimator and all-ones decoder weights."""
        self.LLRest.reset_parameters(generator)
        if self.trainable_bp:
            with torch.no_grad():
                for name in _BP_WEIGHTS.values():
                    getattr(self, name).fill_(1.0)

    def _decoder_weights(self) -> dict[str, torch.Tensor] | None:
        """The BP weights under ``bp_decode``'s names (None without)."""
        if not self.trainable_bp:
            return None
        return {k: getattr(self, v) for k, v in _BP_WEIGHTS.items()}

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        llr = self.LLRest(signal).reshape(-1, self.code.n)
        return bp_decode(llr, self.code, iterations=self.iterations,
                         method=self.method, clamp=self.clamp,
                         weights=self._decoder_weights(), output="soft")
