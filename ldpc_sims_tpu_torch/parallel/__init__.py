"""The Monte-Carlo sweep engine (one device)."""

from ldpc_sims_tpu_torch.parallel.mc import (  # noqa: F401
    SweepConfig,
    SweepResult,
    mc_step,
    run_sweep,
)
