"""Utilities: metrics, phase timers, profiler traces, the run registry,
device selection, decoder-weight loading."""

from ldpc_sims_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_decoder_weights,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device  # noqa: F401
from ldpc_sims_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    PhaseTimer,
    profile_trace,
)
from ldpc_sims_tpu_torch.utils.registry import (  # noqa: F401
    find_runs,
    load_runs,
    record_run,
)
