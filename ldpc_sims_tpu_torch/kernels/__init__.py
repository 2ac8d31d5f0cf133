"""Hand-written CUDA kernels for the hot decode path (built on first use)."""

from ldpc_sims_tpu_torch.kernels.minsum_qc import (  # noqa: F401
    LAUNCHES,
    bp_qc_cuda,
    bp_qc_requeue,
    default_threads,
    minsum_qc_cuda,
    reset_launch_counts,
)
