"""Utilities: checkpoints (the JAX package's format), metrics, phase
timers, profiler traces, the run registry, device selection."""

from ldpc_sims_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    load_decoder_weights,
    save_checkpoint,
)
from ldpc_sims_tpu_torch.utils.device import resolve_device  # noqa: F401
from ldpc_sims_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    PhaseTimer,
    profile_trace,
    stable_fold_in,
)
from ldpc_sims_tpu_torch.utils.registry import (  # noqa: F401
    find_runs,
    load_runs,
    record_run,
)
