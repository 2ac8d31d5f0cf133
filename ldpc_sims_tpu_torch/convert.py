"""Carry codes, trained schedules and LLR-estimator weights across from
the JAX package's arrays.

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
    "llr_params_to_flax",
    "llr_state_dict_from_flax",
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


def llr_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax LLR-estimator param tree → the port's state dict.

    ``params`` is ``model.init``'s output (``{"params": {...}}``) or the
    inner dict, its leaves NumPy (or anything ``np.asarray`` takes). Each
    flax ``Dense`` named ``layer`` becomes ``layer.weight`` (its
    ``kernel`` (in, out) transposed to (out, in)) and ``layer.bias``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for layer, leaves in params.items():
        unknown = set(leaves) - {"kernel", "bias"}
        if unknown or "kernel" not in leaves:
            raise ValueError(f"flax layer {layer!r} holds {sorted(leaves)}; "
                             "expected a Dense's kernel (and bias)")
        out[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(leaves["kernel"], np.float32).T))
        if "bias" in leaves:
            out[f"{layer}.bias"] = torch.from_numpy(
                np.asarray(leaves["bias"], np.float32).copy())
    return out


def llr_params_to_flax(module: torch.nn.Module) -> dict:
    """The inverse of :func:`llr_state_dict_from_flax`: a port estimator's
    weights as flax's variables ``{"params": {layer: {"kernel", "bias"}}}``
    of NumPy float32 arrays, the tree the JAX package's ``model.apply``
    and its checkpoints hold."""
    layers: dict[str, dict] = {}
    for key, t in module.state_dict().items():
        layer, kind = key.rsplit(".", 1)
        a = t.detach().to("cpu", torch.float32).numpy()
        layers.setdefault(layer, {})[
            "kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(a.T) if kind == "weight" else a.copy())
    return {"params": layers}
