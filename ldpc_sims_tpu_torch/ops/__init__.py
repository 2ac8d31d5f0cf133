"""PyTorch compute ops: BP decoding, PHY chain, encoding, link step."""

from ldpc_sims_tpu_torch.ops.bp import (  # noqa: F401
    bp_decode,
    decode_to_bits,
    freeze_minsum_weights,
    init_minsum_weights,
    init_neural_bp_weights,
    pack_decoder_weights,
    syndrome,
    syndrome_from_bits_nb,
)
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step  # noqa: F401
from ldpc_sims_tpu_torch.ops.encode import encode  # noqa: F401
from ldpc_sims_tpu_torch.ops import phy  # noqa: F401
