"""``torch.nn`` models: the neural LLR estimators and the joint LLR→BP
model (the port of ``ldpc_sims_tpu.models``; the neural-BP decoder itself
is a weight dict over ``ops/bp.py``, :func:`..ops.bp.init_neural_bp_weights`)."""

from ldpc_sims_tpu_torch.models.llr import (  # noqa: F401
    LLRestimator,
    LLRestimatorTanh,
    LLRestimatorWithSNR,
)
from ldpc_sims_tpu_torch.models.joint import Joint  # noqa: F401

__all__ = ["LLRestimator", "LLRestimatorWithSNR", "LLRestimatorTanh",
           "Joint"]
