"""Checkpoints in the JAX package's on-disk format (the port of
``utils/checkpoint.py``).

A checkpoint is a directory holding ``params.msgpack`` (flax
``to_bytes`` of the saved tree: params, optimizer state, ...) and
``manifest.json`` (epoch, config, data provenance, loss history). The
port reads and writes both with its own msgpack codec
(:mod:`ldpc_sims_tpu_torch.utils.msgpack_codec`), so checkpoints written by the
JAX package's trainers load here unchanged and the port's load in the
JAX package's ``load_checkpoint(path, template)``. Without a template
the tree comes back as nested dicts of NumPy arrays: an optax
``opt_state`` (a tuple of named tuples when it was saved) reads as dicts
keyed '0', '1', ... and by field name.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ldpc_sims_tpu_torch.utils.msgpack_codec import restore, serialize

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "load_decoder_weights",
]

KNOWN_KEYS = frozenset({
    "w_msg", "w_llr", "w_msg_final", "w_llr_final", "w_pair",
    "ms_alpha", "ms_beta",
})


def _jsonable(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def _as_leaves(tree: Any) -> Any:
    """The JAX package's ``jax.tree.map(np.asarray, tree)``: every leaf an
    array (tensors to NumPy, bfloat16 tensors kept), None kept, and each
    dict rebuilt with its keys sorted, as JAX's tree functions do (so the
    bytes equal the JAX package's for the same tree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_as_leaves(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_leaves(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def save_checkpoint(
    path: str,
    tree: Any,
    manifest: dict[str, Any] | None = None,
) -> str:
    """Write ``tree`` (params, optimizer state, ...) and its manifest."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(serialize(_as_leaves(tree)))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(_jsonable(manifest or {}), f, indent=1, default=str)
    return path


def load_checkpoint(path: str) -> tuple[Any, dict[str, Any]]:
    """The raw tree (nested dicts of NumPy arrays) and the manifest ({}
    when the directory has none)."""
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        tree = restore(f.read())
    manifest_path = os.path.join(path, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    return tree, manifest


def load_decoder_weights(path: str) -> dict[str, np.ndarray]:
    """Load a trained decoder-weight dict for ``bp_decode(weights=)``.

    ``path`` is a ``.npz`` file of flat arrays (such as the committed
    ``docs/artifacts/edge_layered_1944_K*.npz``) or a checkpoint
    directory of the JAX package's ``train_neural_bp`` /
    ``train_minsum_weights``; there a ``params`` entry is unwrapped when
    no decoder key is at the top. Its keys must come from the
    decoder-weight set (per-edge ``w_*`` and ``ms_alpha``/``ms_beta``), as
    in the JAX package. Returns the arrays as NumPy.
    """
    if path.endswith(".npz"):
        with np.load(path) as z:
            tree = {k: z[k] for k in z.files}
    else:
        tree, _ = load_checkpoint(path)
        if not isinstance(tree, dict):
            raise ValueError(
                f"checkpoint {path} does not hold a weight dict"
            )
        if "params" in tree and not (KNOWN_KEYS & set(tree)):
            tree = tree["params"]
    bad = set(tree) - KNOWN_KEYS
    if bad or not tree:
        raise ValueError(
            f"{path} holds keys {sorted(tree)}; expected decoder-weight "
            f"keys from {sorted(KNOWN_KEYS)} (is this an LLR-model "
            "checkpoint? those go to --ckpt, not --weights-ckpt)"
        )
    return {k: np.asarray(v) for k, v in tree.items()}


def latest_checkpoint(root: str, prefix: str = "") -> str | None:
    """Most recently modified checkpoint dir under ``root``."""
    if not os.path.isdir(root):
        return None
    cands = [
        os.path.join(root, d)
        for d in os.listdir(root)
        if d.startswith(prefix)
        and os.path.isfile(os.path.join(root, d, "params.msgpack"))
    ]
    return max(cands, key=os.path.getmtime) if cands else None
