"""Carry codes and trained schedules across from the JAX package's arrays.

Everything here takes plain NumPy arrays or the committed JSON registry,
so the port needs nothing of the JAX package to read them.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode, QcStructure

__all__ = [
    "code_from_numpy",
    "decoder_weights_from_numpy",
    "load_trained_schedule",
    "minsum_schedule_from_numpy",
]


def decoder_weights_from_numpy(tree: dict, device) -> dict:
    """A decoder-weight dict of the JAX package (NumPy or JAX arrays, as
    ``load_decoder_weights`` returns them) → the same keys as float32
    tensors on ``device``; tensors already there pass through."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v), dtype=torch.float32,
                               device=device)
            for k, v in tree.items()}


def code_from_numpy(name: str, H, z: int | None = None,
                    base=None) -> LdpcCode:
    """The port's :class:`LdpcCode` from a parity-check matrix and, for a
    QC code, its lifting size ``z`` and shift ``base`` matrix (−1 = zero
    block)."""
    if (z is None) != (base is None):
        raise ValueError("pass both z and base for a QC code, or neither")
    qc = None
    if base is not None:
        qc = QcStructure(
            z=int(z),
            base=tuple(tuple(int(s) for s in row) for row in np.asarray(base)),
        )
    return LdpcCode(name=name, H=np.asarray(H), qc=qc)


def minsum_schedule_from_numpy(ms_alpha, ms_beta) -> tuple[tuple, tuple]:
    """Per-iteration (α, β) arrays → the tuples ``bp_decode`` takes."""
    a = tuple(float(x) for x in np.asarray(ms_alpha, np.float64).ravel())
    b = tuple(float(x) for x in np.asarray(ms_beta, np.float64).ravel())
    if len(a) != len(b):
        raise ValueError(f"alpha has {len(a)} entries, beta {len(b)}")
    return a, b


def load_trained_schedule(path: str, code_name: str,
                          K: int) -> tuple[tuple, tuple]:
    """The trained layered-``K`` (α, β) schedule of ``code_name`` from the
    registry JSON (``docs/artifacts/minsum_trained_schedules.json``)."""
    with open(path) as f:
        reg = json.load(f)
    try:
        entry = reg[code_name]["layered"][str(K)]
    except KeyError:
        raise KeyError(
            f"no trained layered-{K} schedule for {code_name!r} in {path}"
        ) from None
    return minsum_schedule_from_numpy(entry["alpha"], entry["beta"])
