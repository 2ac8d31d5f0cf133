"""``torch.nn`` models: the neural LLR estimators (the port of
``ldpc_sims_tpu.models``; the joint LLR→BP model is still to port)."""

from ldpc_sims_tpu_torch.models.llr import (  # noqa: F401
    LLRestimator,
    LLRestimatorTanh,
    LLRestimatorWithSNR,
)

__all__ = ["LLRestimator", "LLRestimatorWithSNR", "LLRestimatorTanh"]
