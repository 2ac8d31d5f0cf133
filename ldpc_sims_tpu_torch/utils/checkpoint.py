"""Decoder-weight checkpoints: the port of
``utils/checkpoint.py:load_decoder_weights`` for ``.npz`` files.

The JAX package also reads checkpoint directories (flax msgpack, written
by its trainers); the port has no trainer yet and will write torch
checkpoints of its own (ROADMAP A8 and A10), so a directory raises.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_decoder_weights"]

KNOWN_KEYS = frozenset({
    "w_msg", "w_llr", "w_msg_final", "w_llr_final", "w_pair",
    "ms_alpha", "ms_beta",
})


def load_decoder_weights(path: str) -> dict[str, np.ndarray]:
    """Load a trained decoder-weight dict for ``bp_decode(weights=)``.

    ``path`` is a ``.npz`` file of flat arrays, such as the committed
    ``docs/artifacts/edge_layered_1944_K*.npz``. Its keys must come from
    the decoder-weight set (per-edge ``w_*`` and ``ms_alpha``/``ms_beta``),
    as in the JAX package. Returns the arrays as NumPy.
    """
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: checkpoint directories are flax msgpack trees of the "
            "JAX package's trainers; the port reads .npz weight files only "
            "(torch checkpoints: ROADMAP A8 and A10)"
        )
    with np.load(path) as z:
        tree = {k: z[k] for k in z.files}
    bad = set(tree) - KNOWN_KEYS
    if bad or not tree:
        raise ValueError(
            f"{path} holds keys {sorted(tree)}; expected decoder-weight "
            f"keys from {sorted(KNOWN_KEYS)} (is this an LLR-model "
            "checkpoint? those go to --ckpt, not --weights-ckpt)"
        )
    return {k: np.asarray(v) for k, v in tree.items()}
