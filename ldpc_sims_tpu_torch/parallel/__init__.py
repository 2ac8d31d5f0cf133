"""Process meshes on ``torch.distributed`` and the sharded Monte-Carlo
sweep engine."""

from ldpc_sims_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    local_batch_multiple,
    make_mesh,
    maybe_distributed_init,
)
from ldpc_sims_tpu_torch.parallel.mc import (  # noqa: F401
    SweepConfig,
    SweepResult,
    mc_step,
    run_grid,
    run_sweep,
    scaling_probe,
)
