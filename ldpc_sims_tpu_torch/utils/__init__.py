"""Utilities: phase timers, device selection."""

from ldpc_sims_tpu_torch.utils.device import resolve_device  # noqa: F401
from ldpc_sims_tpu_torch.utils.metrics import PhaseTimer  # noqa: F401
