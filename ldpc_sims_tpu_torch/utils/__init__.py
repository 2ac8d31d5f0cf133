"""Utilities: phase timers, device selection, decoder-weight loading."""

from ldpc_sims_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_decoder_weights,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device  # noqa: F401
from ldpc_sims_tpu_torch.utils.metrics import PhaseTimer  # noqa: F401
