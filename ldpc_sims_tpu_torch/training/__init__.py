"""Training recipes and dataset builders for the learned receivers and
decoders (the port of ``ldpc_sims_tpu.training``)."""

from ldpc_sims_tpu_torch.training.data import (  # noqa: F401
    make_joint_dataset,
    make_llr_dataset,
)
from ldpc_sims_tpu_torch.training.trainer import (  # noqa: F401
    TrainConfig,
    decoded_ber_probe,
    train_joint,
    train_llr,
    train_minsum_weights,
    train_neural_bp,
)

__all__ = [
    "TrainConfig",
    "decoded_ber_probe",
    "make_joint_dataset",
    "make_llr_dataset",
    "train_joint",
    "train_llr",
    "train_minsum_weights",
    "train_neural_bp",
]
