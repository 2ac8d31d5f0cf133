"""Carry codes, trained schedules, model weights and optimizer state
across from the JAX package's arrays.

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
    "joint_params_to_flax",
    "joint_state_dict_from_flax",
    "llr_params_to_flax",
    "llr_state_dict_from_flax",
    "load_trained_schedule",
    "minsum_schedule_from_numpy",
    "optimizer_state_from_flax",
    "optimizer_state_to_flax",
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
    return _flax_tree(module.state_dict())


def joint_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax ``Joint`` param tree → the port's :class:`..models.Joint`
    state dict: the ``LLRest`` subtree as :func:`llr_state_dict_from_flax`
    under ``LLRest.``, and each ``bp_w_*`` array as it is."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {f"LLRest.{k}": v
           for k, v in llr_state_dict_from_flax(params["LLRest"]).items()}
    for name, leaf in params.items():
        if name != "LLRest":
            out[name] = torch.from_numpy(np.asarray(leaf, np.float32).copy())
    return out


def joint_params_to_flax(module: torch.nn.Module) -> dict:
    """The inverse of :func:`joint_state_dict_from_flax`: a port ``Joint``
    as flax's variables ``{"params": {"LLRest": {...}, "bp_w_*": ...}}``
    of NumPy float32 arrays."""
    return _flax_tree(module.state_dict())


def _flax_leaf(name: str) -> tuple[tuple[str, ...], bool]:
    """A parameter's path in the flax tree and whether it is transposed:
    ``a.b.weight`` → (a, b, kernel), transposed; ``a.b.bias`` → (a, b,
    bias); a bare parameter (``bp_w_msg``) keeps its name."""
    parts = name.split(".")
    if len(parts) > 1 and parts[-1] == "weight":
        return (*parts[:-1], "kernel"), True
    return tuple(parts), False


def _flax_tree(named: dict[str, torch.Tensor]) -> dict:
    """``{name: tensor}`` → flax's nested ``{"params": ...}`` of NumPy."""
    tree: dict = {}
    for name, t in named.items():
        path, transpose = _flax_leaf(name)
        a = t.detach().to("cpu", torch.float32).numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(a.T) if transpose else a.copy()
    return {"params": tree}


def _flax_lookup(tree: dict, name: str) -> np.ndarray:
    path, transpose = _flax_leaf(name)
    node = tree["params"]
    for key in path:
        node = node[key]
    a = np.asarray(node, np.float32)
    return np.ascontiguousarray(a.T) if transpose else a


def _optimizer_kind(opt: torch.optim.Optimizer) -> str:
    if isinstance(opt, torch.optim.Adam):
        return "adam"
    if isinstance(opt, torch.optim.SGD):
        return "sgd"
    raise TypeError(f"no optax layout for {type(opt).__name__}; the "
                    "trainers use torch.optim.SGD and torch.optim.Adam")


def _chain_state(opt, named: dict, members: set) -> dict:
    """optax's chain state for ``members`` of ``named``, as flax's
    ``to_state_dict`` lays it out: ``sgd`` = (EmptyState, EmptyState) →
    ``{"0": {}, "1": {}}``; ``adam`` = (ScaleByAdamState(count, mu, nu),
    EmptyState) with ``count`` int32 and ``mu``/``nu`` param-shaped trees,
    each top-level subtree outside ``members`` a masked node (``{}``)."""
    if _optimizer_kind(opt) == "sgd":
        return {"0": {}, "1": {}}
    count = 0
    moments = {}
    for key, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        vals = {}
        for name in members:
            state = opt.state.get(named[name], {})
            vals[name] = state.get(src, torch.zeros_like(named[name]))
            if "step" in state:
                count = max(count, int(state["step"]))
        tree = _flax_tree(vals)["params"]
        for name in named:  # masked top-level subtrees
            tree.setdefault(name.split(".")[0], {})
        moments[key] = {"params": tree}
    return {"0": {"count": np.asarray(count, np.int32), **moments}, "1": {}}


def _group_members(opt, named: dict, groups) -> dict[str, set]:
    """label → the names of the parameters in its param group."""
    out = {}
    for label, index in groups.items():
        ids = {id(p) for p in opt.param_groups[index]["params"]}
        out[label] = {n for n, p in named.items() if id(p) in ids}
    return out


def optimizer_state_to_flax(opt: torch.optim.Optimizer,
                            module: torch.nn.Module,
                            groups: dict[str, int] | None = None) -> dict:
    """A ``torch.optim.SGD``/``Adam`` state → the tree flax's serializer
    writes for the same optax optimizer over ``module``'s flax params.

    ``groups`` None: ``optax.sgd``/``optax.adam`` over every parameter.
    ``groups`` ``{label: param-group index}``: ``optax.multi_transform``
    with one such transform a label (the joint recipe's ``llr``/``bp``),
    ``{"inner_states": {label: {"inner_state": chain state}}}``, each
    label's moments masked outside its group. Adam's ``count`` is int32
    there; torch's ``step`` is a float.
    """
    named = dict(module.named_parameters())
    if groups is None:
        return _chain_state(opt, named, set(named))
    members = _group_members(opt, named, groups)
    return {"inner_states": {
        label: {"inner_state": _chain_state(opt, named, members[label])}
        for label in groups}}


def optimizer_state_from_flax(opt: torch.optim.Optimizer,
                              module: torch.nn.Module, tree: dict,
                              groups: dict[str, int] | None = None) -> None:
    """The inverse of :func:`optimizer_state_to_flax`: load an optax
    ``opt_state`` (as ``load_checkpoint`` returns it, or as the JAX
    package writes it) into ``opt``'s state for ``module``'s parameters.
    SGD holds no state; Adam takes ``exp_avg``/``exp_avg_sq`` and a float
    ``step``."""
    if _optimizer_kind(opt) == "sgd":
        return
    named = dict(module.named_parameters())
    if groups is None:
        parts = [(tree, set(named))]
    else:
        members = _group_members(opt, named, groups)
        parts = [(tree["inner_states"][label]["inner_state"],
                  members[label]) for label in groups]
    for chain, names in parts:
        adam = chain["0"]
        for name in names:
            p = named[name]
            opt.state[p] = {
                "step": torch.tensor(float(np.asarray(adam["count"]))),
                "exp_avg": torch.from_numpy(_flax_lookup(
                    adam["mu"], name).copy()).to(p.device),
                "exp_avg_sq": torch.from_numpy(_flax_lookup(
                    adam["nu"], name).copy()).to(p.device),
            }
