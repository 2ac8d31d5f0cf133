"""PyTorch compute ops: BP decoding, PHY chain, encoding, link step."""

from ldpc_sims_tpu_torch.ops.bp import (  # noqa: F401
    bp_decode,
    freeze_minsum_weights,
)
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step  # noqa: F401
from ldpc_sims_tpu_torch.ops.encode import encode  # noqa: F401
from ldpc_sims_tpu_torch.ops import phy  # noqa: F401
