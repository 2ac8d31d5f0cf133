"""Plain PyTorch QC-LDPC BP decode: the port of ``ops/bp_roll.py``.

This module is the plain version of the CUDA decode kernels
(:mod:`ldpc_sims_tpu_torch.kernels.minsum_qc`): the CPU runs it, the tests
hold it against the JAX package, and ``chip_smoke.py`` holds each kernel
against it on the card. It repeats the kernels' arithmetic in the same
order, so on one device the two agree to the last bit.

For a QC code, H is an (mb × nb) grid of z×z circulants with shifts
s_ij. Messages are kept as one plane of shape (batch, z) per nonzero
block, and moving a plane between check orientation and variable
orientation is ``torch.roll(plane, ±s, dims=-1)``.

Plane convention (check orientation): for block (i, j) with shift s,
``plane[b, r]`` is the message on the edge between check ``i·z + r`` and
variable ``j·z + (r + s) mod z``. Variable orientation is
``roll(plane, s)`` (column q ↔ variable j·z+q); the inverse is
``roll(·, −s)``. ``torch.roll`` and ``jnp.roll`` shift the same way.

Scope: min-sum with scalar or per-iteration α/β (tuples, or the
``ms_weights`` tensors gradients flow through), the stable log-domain
sum-product and the reference's tanh-product rule (``sum-product-ref``,
which no kernel has), optional clamp and message quantization
(``msg_qbits``),
per-edge neural-BP weights, flooding, layered (serial-C) and
group-serial layered schedules, per-codeword early stop with a check
stride, a mask of codewords to skip, the outputs ``hard``,
``posterior``, ``hard_iters`` and ``hard_unsat``, the Pallas
kernel's bf16 and int8 message storage (``dtype``), and JAX's roll
backend's bf16 arithmetic (``arith``).
:func:`..ops.bp.bp_decode` rejects what the JAX function takes beyond
that, naming its ROADMAP item.

On the card every elementwise operation here is one CUDA kernel that
computes each element alone (``exp``, ``expm1``, ``log1p`` and ``log``
are libdevice's), as the decode kernels do. On the CPU PyTorch computes
some transcendentals (``log1p``) one way in vector lanes and another in
a tensor's scalar tail, so a sum-product result there can differ in the
last bit with the position of a codeword in the batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import QcStructure

__all__ = [
    "EDGE_KEYS",
    "NO_GRADIENT",
    "STORAGE_DTYPES",
    "EdgeTables",
    "decode_roll",
    "message_storage",
    "msg_qstep",
    "needs_gradient",
    "pack_edge_weights",
    "qc_plan",
    "storage_dtype",
    "unsat_checks",
]

_BIG = 1e30
_REF_PROD_EPS = 1e-7  # the reference's product clamp (bp/bp_cv.py:44)
# the arrays of an edge-flavor neural-BP weight set
EDGE_KEYS = frozenset({"w_msg", "w_llr", "w_msg_final", "w_llr_final"})


def qc_plan(qc: QcStructure):
    """Static decode plan: plane list + per-check/per-var groupings.

    Planes are ordered block-row-major (sorted by (i, j)); a variable
    block's planes are listed sorted by check-block row i — the same
    check-sorted slot order as ``TannerGraph`` variable slots.
    """
    planes: list[tuple[int, int, int]] = []  # (i, j, shift)
    for i, row in enumerate(qc.base):
        for j, s in enumerate(row):
            if s >= 0:
                planes.append((i, j, int(s)))
    group_c: list[list[int]] = [[] for _ in range(qc.mb)]
    group_v: list[list[int]] = [[] for _ in range(qc.nb)]
    for p, (i, j, _s) in enumerate(planes):
        group_c[i].append(p)
        group_v[j].append(p)
    # planes are (i, j)-sorted so group_c entries are j-sorted and
    # group_v entries are i-sorted already
    return planes, group_c, group_v


# the message storage types of the kernels, by name
STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}


def storage_dtype(dtype) -> torch.dtype:
    """A message storage type (a torch dtype or its name) → the torch
    dtype; raises ValueError for any other."""
    if isinstance(dtype, str):
        dtype = STORAGE_DTYPES.get(dtype, dtype)
    if dtype not in STORAGE_DTYPES.values():
        raise ValueError(f"message storage dtype must be one of "
                         f"{sorted(STORAGE_DTYPES)}, got {dtype!r}")
    return dtype


def message_storage(dtype, msg_qclip: float, device=None):
    """``(st_msg, st_post)``: f32 tensor → the f32 values that the storage
    of type ``dtype`` holds for messages and for the posterior (and
    channel LLRs), the Pallas kernel's ``ld(st(v))``. bf16 rounds both to
    nearest even; int8 maps a message to ``clip(round(v·(1/qstep)), −127,
    127)·qstep``, ``qstep = 2·msg_qclip/255``, and leaves the posterior
    f32; float32 leaves both."""
    dtype = storage_dtype(dtype)

    def bf16(v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.bfloat16).to(torch.float32)

    def same(v: torch.Tensor) -> torch.Tensor:
        return v

    if dtype == torch.bfloat16:
        return bf16, bf16
    if dtype == torch.float32:
        return same, same
    if not msg_qclip > 0:
        raise ValueError(f"int8 storage needs msg_qclip > 0, got "
                         f"{msg_qclip!r}")
    # the grid's step and the reciprocal that stores onto it, both taken
    # in double and rounded once to f32 tensor constants (a Python scalar
    # would not be the f32 operand the kernels use on a CUDA tensor)
    step = 2.0 * msg_qclip / 255.0
    s_step = torch.tensor(step, dtype=torch.float32, device=device)
    s_inv = torch.tensor(1.0 / step, dtype=torch.float32, device=device)

    def int8(v: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(v * s_inv), -127.0, 127.0) * s_step

    return int8, same


def msg_qstep(msg_qbits: int | None, msg_qclip: float) -> float | None:
    """The message quantization step ``2·msg_qclip/(2**msg_qbits − 1)``,
    or None without quantization."""
    if msg_qbits is None:
        return None
    if int(msg_qbits) != msg_qbits or msg_qbits < 1 or not msg_qclip > 0:
        raise ValueError(f"msg_qbits={msg_qbits!r} must be a positive "
                         f"integer and msg_qclip={msg_qclip!r} positive")
    return 2.0 * msg_qclip / (2**int(msg_qbits) - 1)


class EdgeTables(NamedTuple):
    """Edge-flavor neural-BP weights in the decode kernels' layout.

    ``msg``: (iterations+1, P, z) float32, plane p's weight on the edge of
    check ``i·z + r`` at ``[t, p, r]``, that is the variable-space weight
    pre-rolled to check orientation (``roll(w ⊙ roll(m, s), −s) ==
    roll(w, −s) ⊙ m``); ``llr``: (iterations+1, nb, z) float32. Row
    ``iterations`` of each holds the final-marginalization weights.
    """

    msg: torch.Tensor
    llr: torch.Tensor


@functools.lru_cache(maxsize=32)
def _edge_index(qc: QcStructure, dv: int) -> np.ndarray:
    """(P·z,) flat index into a (n·dv) variable-space weight row of the
    weight of plane p's edge at check offset r (the slot of plane p among
    its variable block's check-sorted planes)."""
    planes, _, group_v = qc_plan(qc)
    z = qc.z
    idx = np.empty((len(planes), z), np.int64)
    r = np.arange(z)
    for j, ps in enumerate(group_v):
        for kv, p in enumerate(ps):
            if kv >= dv:
                raise ValueError(f"w_msg has {dv} slots per variable; "
                                 f"column block {j} has degree {len(ps)}")
            s = planes[p][2]
            idx[p] = (j * z + (r + s) % z) * dv + kv
    return idx.reshape(-1)


def pack_edge_weights(weights, qc: QcStructure, iterations: int,
                      device=None) -> EdgeTables:
    """Edge-flavor weights (JAX's layout) → :class:`EdgeTables`.

    The counterpart of ``_pack_edge_weights``
    (``ldpc_sims_tpu/kernels/minsum_qc.py:533-593``), with its shape
    checks and messages: ``w_msg`` (iterations, n, dv) in variable space
    with check-sorted slots, ``w_llr`` (iterations, n), and the
    ``*_final`` marginalization weights. Arrays may be NumPy or tensors;
    made of torch operations, so a gradient flows through it. An
    :class:`EdgeTables` passes through after its shapes are checked; a
    dict that is not the edge flavor raises, as in JAX.
    """
    planes = qc_plan(qc)[0]
    nb, z = qc.nb, qc.z
    n = nb * z
    if isinstance(weights, EdgeTables):
        want = ((iterations + 1, len(planes), z), (iterations + 1, nb, z))
        got = (tuple(weights.msg.shape), tuple(weights.llr.shape))
        if got != want:
            raise ValueError(f"edge tables of shapes {got} != {want}")
        return weights

    missing = set(EDGE_KEYS) - set(weights)
    if missing or "w_pair" in weights:
        raise ValueError("kernel weights must be the edge flavor "
                         f"(missing {missing or 'nothing'}; w_pair "
                         "unsupported)")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    wm = f32(weights["w_msg"])
    dv = wm.shape[-1] if wm.dim() else 0
    if tuple(wm.shape) != (iterations, n, dv):
        raise ValueError(
            f"w_msg shape {tuple(wm.shape)} != ({iterations}, {n}, dv)")
    dev = wm.device
    wmf = f32(weights["w_msg_final"]).to(dev)
    if tuple(wmf.shape) != (n, dv):
        raise ValueError(f"w_msg_final shape {tuple(wmf.shape)} != ({n}, "
                         f"{dv})")
    wl = f32(weights["w_llr"]).to(dev)
    if tuple(wl.shape) != (iterations, n):
        raise ValueError(f"w_llr shape {tuple(wl.shape)} != ({iterations}, "
                         f"{n})")
    wlf = f32(weights["w_llr_final"]).to(dev).reshape(1, n)
    idx = torch.from_numpy(_edge_index(qc, dv)).to(dev)
    w_all = torch.cat([wm, wmf[None]]).reshape(iterations + 1, n * dv)
    return EdgeTables(
        msg=w_all.index_select(1, idx).reshape(iterations + 1, len(planes),
                                               z),
        llr=torch.cat([wl, wlf]).reshape(iterations + 1, nb, z),
    )


# why the kernels refuse an input that needs a gradient
NO_GRADIENT = (
    "the decode kernels carry no gradient, as the JAX package's Pallas "
    "kernel carries none: LLRs or decoder weights that need one decode "
    "with backend='roll' (or 'gather' for a non-QC code), which "
    "backend='auto' takes for them")


def needs_gradient(*tensors) -> bool:
    """True when autograd is recording and one of ``tensors`` (None and
    non-tensors allowed) requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _exclusive_sign(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive sign product over ``dim`` as a negative-count parity.

    A strict ``x < 0`` test: −0.0 counts as positive, as in the kernels.
    """
    neg = (x < 0).to(x.dtype)
    ex = neg.sum(dim, keepdim=True) - neg
    return 1.0 - 2.0 * torch.remainder(ex, 2.0)


def _exclusive_prod(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive product over ``dim`` as prefix × suffix products (JAX's
    ``_exclusive_prod``: never divides)."""
    one = torch.ones_like(t.narrow(dim, 0, 1))
    n = t.shape[dim]
    left = torch.cat([one, torch.cumprod(t, dim).narrow(dim, 0, n - 1)],
                     dim)
    right = torch.flip(torch.cumprod(torch.flip(t, [dim]), dim), [dim])
    return left * torch.cat([right.narrow(dim, 1, n - 1), one], dim)


def _exclusive_sum(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive sum over ``dim`` as prefix + suffix sums (JAX's
    ``_exclusive_sum``: no cancellation)."""
    zero = torch.zeros_like(t.narrow(dim, 0, 1))
    n = t.shape[dim]
    left = torch.cat([zero, torch.cumsum(t, dim).narrow(dim, 0, n - 1)],
                     dim)
    right = torch.flip(torch.cumsum(torch.flip(t, [dim]), dim), [dim])
    return left + torch.cat([right.narrow(dim, 1, n - 1), zero], dim)


def _minsum_excl(x: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Exclusive min-sum over dim 0 of (d, B, z) via two minima:
    ``exsign · max(exmin − β, 0) · α``."""
    a = x.abs()
    min1, idx = a.min(0, keepdim=True)  # first index of the minimum
    if needs_gradient(a):
        # the same value, with JAX's subgradient: jnp.min splits it evenly
        # over tied minima, where min's values send it to one index
        min1 = a.amin(0, keepdim=True)
    onehot = torch.arange(x.shape[0], device=x.device).view(-1, 1, 1) == idx
    min2 = torch.where(onehot, _BIG, a).amin(0, keepdim=True)
    exmin = torch.where(onehot, min2, min1)
    exsign = _exclusive_sign(x)
    return exsign * torch.clamp_min(exmin - beta, 0.0) * alpha


def _sumproduct_excl(x: torch.Tensor, serial: bool = True) -> torch.Tensor:
    """Stable exclusive sum-product over dim 0 of (d, B, z), the JAX roll
    backend's ``expm1``/``log1p`` form: ``a = max(|x|, 1e-12)``,
    ``lt = log(−expm1(−a)) − log1p(exp(−a))``, ``s = min(Σlt − lt,
    −1e-12)``, magnitude ``log1p(exp(s)) − log(−expm1(s))`` (at most
    28.3). The row sum runs left to right over the slots, as the kernels
    take it (``serial``), or as one reduction, as JAX's roll backend
    takes it."""
    a = torch.clamp_min(x.abs(), 1e-12)
    lt = torch.log(-torch.expm1(-a)) - torch.log1p(torch.exp(-a))
    if serial:
        total = torch.zeros_like(lt[0])
        for k in range(lt.shape[0]):
            total = total + lt[k]
    else:
        total = lt.sum(0)
    s = torch.clamp_max(total - lt, -1e-12)
    mag = torch.log1p(torch.exp(s)) - torch.log(-torch.expm1(s))
    return _exclusive_sign(x) * mag


def _as_bf16(v: float) -> float:
    """A Python number rounded to bf16 (to nearest even)."""
    return float(torch.tensor(float(v), dtype=torch.bfloat16))


def _ref_excl(t: torch.Tensor) -> torch.Tensor:
    """The reference's check rule on tanh of the half messages over dim 0
    (JAX's ``_check_update_ref``/roll ``_ref_excl``, ``bp/bp_cv.py``):
    their exclusive product, clipped to ±(1 − 1e-7), then
    ``log((1 + p)/(1 − p))``."""
    p = torch.clamp(_exclusive_prod(t), -(1 - _REF_PROD_EPS),
                    1 - _REF_PROD_EPS)
    return torch.log((1.0 + p) / (1.0 - p))


def unsat_checks(post: torch.Tensor, qc: QcStructure) -> torch.Tensor:
    """(B,) int32 count of unsatisfied checks of the hard decisions of a
    (B, nb, z) internal posterior (log Pr0/Pr1: bit 1 where post < 0)."""
    planes, group_c, _ = qc_plan(qc)
    bits = (post < 0).to(torch.int32)
    total = torch.zeros(post.shape[0], dtype=torch.int32, device=post.device)
    for ps in group_c:
        # check i·z+r sees variable j·z+(r+s): roll the bits by −s
        par = sum(torch.roll(bits[:, planes[p][1]], -planes[p][2], -1)
                  for p in ps)
        total += (par & 1).sum(-1, dtype=torch.int32)
    return total


def decode_roll(
    llr: torch.Tensor,
    qc: QcStructure,
    *,
    iterations: int = 20,
    alpha=1.0,
    beta=0.0,
    clamp: float | None = None,
    output: str = "hard",
    schedule: str = "flooding",
    early_stop: bool = False,
    es_check_every: int = 1,
    done_in: torch.Tensor | None = None,
    method: str = "min-sum",
    msg_qbits: int | None = None,
    msg_qclip: float = 20.0,
    weights=None,
    ms_weights: dict | None = None,
    layered_group: int = 1,
    dtype=torch.float32,
    arith=torch.float32,
):
    """QC-LDPC BP decode; the contract of :func:`..ops.bp.bp_decode` for
    QC codes, and of the Pallas kernel's early-stop, weighted and
    group-serial forms.

    llr: (batch, n) channel LLRs, log(Pr1/Pr0) convention, on any device.
    ``method``: 'min-sum' or 'sum-product'. Min-sum's ``alpha``/``beta``
    may be length-``iterations`` tuples or 1-D tensors (a per-iteration
    normalization/offset schedule); ``ms_weights`` ``{'alpha', 'beta'}``
    is JAX's differentiable form of it, exclusive with tuples.
    Sum-product ignores scalar α/β and rejects per-iteration ones. Each
    c2v message is clamped to ±``clamp``, then with ``msg_qbits`` rounded
    to the step ``2·msg_qclip/(2**msg_qbits − 1)`` (half to even, after a
    true division) and clipped to ±``msg_qclip``.

    ``schedule='flooding'``: each iteration rebuilds the posterior as
    LLR + Σ c2v in check-sorted order, forms v2c = roll(post, −s) − c2v
    and updates every check. ``schedule='layered'``: serial-C over the mb
    block rows, each row reading the current posterior and folding its
    message change back into it. ``layered_group=G > 1`` (the kernels'
    group-serial form, which JAX has in its Pallas kernel only): groups
    of G consecutive block rows, the last one possibly shorter, are
    serial; the rows of a group form their v2c from the posterior as it
    stood before the group, then fold their message changes into it in
    row order, then slot order. G = mb is one flooding iteration up to
    the order of the sums.

    ``weights``: edge-flavor neural-BP weights, JAX's dict
    (:func:`pack_edge_weights`) or :class:`EdgeTables`; iteration t uses
    row t. Flooding: v2c = roll(post_w, −s) − w ⊙ c2v against the
    posterior post_w = wl ⊙ LLR + Σ w ⊙ c2v of row t, and the output is
    the posterior of the final row. Layered: the running posterior
    carries row t's weights, each message change folds in as
    w ⊙ (new − old), and after each sweep the posterior is rebuilt from
    the messages with the next row (the final one after the last
    sweep). Not with early stop.

    ``early_stop``: each codeword freezes at its first syndrome-satisfying
    state, checked on the channel decisions at entry and after every
    ``es_check_every``-th iteration (K must divide ``iterations``); its
    iteration count is 0 at entry, (r+1)·K at the r-th check, and
    ``iterations`` if it never converges. ``done_in``: optional (batch,)
    mask of codewords that are not decoded at all; their output is
    unspecified (zeros here) and, under early stop, their count is 0,
    and the others skip the entry check.

    ``dtype``: the message storage type of the Pallas kernel
    (``_build_kernel``, ldpc_sims_tpu/kernels/minsum_qc.py:130-134,
    :216-228), computed in f32 tensors that hold only the stored values.
    torch.float32 stores nothing narrower. torch.bfloat16 rounds (to
    nearest even) the messages, the posterior and the channel LLRs, these
    on entry. torch.int8 keeps the messages on the grid ``q·qstep``,
    ``qstep = 2·msg_qclip/255``, stored as ``clip(round(v·(1/qstep)),
    −127, 127)`` (half to even, times the f32 reciprocal); the LLRs and
    the posterior stay f32. Flooding stores each v2c before the check
    update reads it back, then stores the check's output; a posterior
    rebuild sums in f32 and rounds once. A layered fold adds
    ``ld(st(new)) − old`` for int8 but the unrounded ``new − old`` for
    bf16, while the message is stored rounded, and re-rounds the
    posterior after each fold.

    ``arith``: the arithmetic of JAX's roll backend
    (``ldpc_sims_tpu/ops/bp_roll.py:180``). torch.float32 is the kernels'
    f32 arithmetic. torch.bfloat16 holds the LLRs, the messages, the
    weights, α/β and every sum in bf16, each operation rounded, in JAX's
    order: flooding forms each v2c as (LLR + Σ c2v) − c2v with the sum
    taken as one reduction, sum-product its row sum likewise. It takes
    f32 storage (``dtype``) only and no ``layered_group``; the posterior
    output holds bf16 values.

    ``method='sum-product-ref'`` is the reference's tanh-product rule
    (JAX's roll ``_ref_excl``); the kernels do not have it.

    Outputs: 'hard' (int8 bits), 'posterior' (f32), 'hard_iters'
    ((bits, iters), iters constant without early stop) and 'hard_unsat'
    ((bits, unsat): the count of unsatisfied checks per codeword after a
    fixed decode; not with early stop).
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if method not in ("min-sum", "sum-product", "sum-product-ref"):
        raise ValueError(f"unknown method {method!r}")
    arith = storage_dtype(arith)
    if arith == torch.int8:
        raise ValueError("arith must be float32 or bfloat16")
    bf16 = arith == torch.bfloat16
    if bf16 and (storage_dtype(dtype) != torch.float32
                 or layered_group != 1):
        raise ValueError("bf16 arithmetic takes f32 storage and "
                         "layered_group=1")
    if output not in ("hard", "posterior", "hard_iters", "hard_unsat"):
        raise ValueError(f"unknown output {output!r}")
    if output == "hard_unsat" and early_stop:
        raise ValueError(
            "output='hard_unsat' is the fixed-decode fused-syndrome path; "
            "early_stop computes syndromes already"
        )
    if es_check_every < 1 or iterations % es_check_every:
        raise ValueError(
            f"es_check_every={es_check_every} must divide "
            f"iterations={iterations}"
        )
    z, nb, mb = qc.z, qc.nb, qc.mb
    planes, group_c, group_v = qc_plan(qc)
    P = len(planes)
    B, n = llr.shape
    if n != nb * z:
        raise ValueError("llr width does not match the QC code")
    dev = llr.device
    if layered_group < 1 or (layered_group > 1 and schedule != "layered"):
        raise ValueError("layered_group needs schedule='layered'")
    if weights is not None and early_stop:
        raise ValueError("early_stop with neural-BP weights is unsupported")

    def per_iteration(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.float32).to(arith)
        if isinstance(v, (tuple, list, np.ndarray)):
            return torch.tensor(np.asarray(v, np.float32),
                                device=dev).to(arith)
        return None

    if ms_weights is not None:
        if isinstance(alpha, (tuple, list)) or isinstance(beta,
                                                          (tuple, list)):
            raise ValueError("pass tuple alpha/beta OR ms_weights, not both")
        if method != "min-sum":
            raise ValueError("ms_weights require method='min-sum'")
        alpha, beta = ms_weights["alpha"], ms_weights["beta"]
    ms_a, ms_b = per_iteration(alpha), per_iteration(beta)
    if bf16:  # JAX casts a Python α/β to the decode's type
        alpha = alpha if ms_a is not None else _as_bf16(alpha)
        beta = beta if ms_b is not None else _as_bf16(beta)
    if (ms_a is not None or ms_b is not None) and method != "min-sum":
        raise ValueError("per-iteration alpha/beta require min-sum")
    wt = None
    if weights is not None:
        wt = pack_edge_weights(weights, qc, iterations, dev)
        if bf16:
            wt = EdgeTables(msg=wt.msg.to(arith), llr=wt.llr.to(arith))
    for arr, name in ((ms_a, "alpha"), (ms_b, "beta")):
        if arr is not None and arr.shape != (iterations,):
            raise ValueError(
                f"per-iteration {name} must have shape ({iterations},), "
                f"got {tuple(arr.shape)}"
            )
    qstep = msg_qstep(msg_qbits, msg_qclip)
    if qstep is not None:
        # a tensor on the device: dividing a CUDA tensor by a Python
        # scalar multiplies by its reciprocal instead
        qstep = torch.tensor(qstep, dtype=torch.float32, device=dev).to(arith)
    dtype = storage_dtype(dtype)
    st_msg, st_post = message_storage(dtype, msg_qclip, dev)

    def excl_update(x: torch.Tensor, it: int) -> torch.Tensor:
        if method == "min-sum":
            a = alpha if ms_a is None else ms_a[it]
            b = beta if ms_b is None else ms_b[it]
            y = _minsum_excl(x, a, b)
        elif method == "sum-product":
            y = _sumproduct_excl(x, serial=not bf16)
        else:
            y = _ref_excl(torch.tanh(x * 0.5))
        if clamp is not None:
            y = torch.clamp(y, -clamp, clamp)
        if qstep is not None:
            y = torch.clamp(torch.round(y / qstep) * qstep, -msg_qclip,
                            msg_qclip)
        return y

    def wmsg(row, p, m):
        """Message m of plane p times its weight in table row ``row``."""
        return m if wt is None else wt.msg[row, p] * m

    # The state of the codewords still being decoded: L (nb planes of
    # (b, z), variable orientation) and c2v (P planes, check orientation).
    # Layered keeps the running posterior in L; flooding keeps the channel
    # LLRs there and rebuilds the posterior from c2v. Every operation is
    # per codeword, so decoding a subset of the rows changes no row.
    def rebuild(Lc: list, c2v: list, row: int) -> list:
        """Posterior planes (wl ⊙) LLR + Σ (w ⊙) c2v in check-sorted
        order, with weight-table row ``row``, each rounded once to the
        posterior's storage."""
        out = []
        for j in range(nb):
            acc = Lc[j] if wt is None else wt.llr[row, j] * Lc[j]
            for p in group_v[j]:
                acc = acc + torch.roll(wmsg(row, p, c2v[p]), planes[p][2],
                                       -1)
            out.append(st_post(acc))
        return out

    def posterior(L: list, c2v: list) -> torch.Tensor:
        if schedule == "layered":
            return torch.stack(L, 1).float()
        # (b, nb, z)
        return torch.stack(rebuild(L, c2v, iterations), 1).float()

    def layer_group(L: list, c2v: list, rows: range, it: int) -> None:
        """The rows' check updates from the posterior L as it stands, then
        their message changes folded into L in row, then slot, order."""
        ys = []
        for i in rows:
            ys.append(excl_update(torch.stack([
                torch.roll(L[planes[p][1]], -planes[p][2], -1)
                - wmsg(it, p, c2v[p])
                for p in group_c[i]
            ]), it))
        for i, y in zip(rows, ys):
            for k, p in enumerate(group_c[i]):
                _, j, s = planes[p]
                new = st_msg(y[k])
                # int8 folds what the stored message changes by, bf16
                # (and f32) the unrounded change
                d = (new if dtype == torch.int8 else y[k]) - c2v[p]
                L[j] = st_post(L[j] + torch.roll(wmsg(it, p, d), s, -1))
                c2v[p] = new

    def iterate(L: list, c2v: list, it: int) -> tuple[list, list]:
        if schedule == "layered":
            L, c2v = list(L), list(c2v)
            for g0 in range(0, mb, layered_group):
                layer_group(L, c2v, range(g0, min(g0 + layered_group, mb)),
                            it)
            if wt is not None:  # re-base onto the next row of weights
                L = rebuild(Lc, c2v, it + 1)
            return L, c2v
        if bf16:
            return L, jax_flooding(L, c2v, it)
        post = torch.stack(rebuild(L, c2v, it), 1)
        new: list = [None] * P
        for i in range(mb):
            ps = group_c[i]
            # flooding passes each v2c through the message storage
            xs = torch.stack([
                st_msg(torch.roll(post[:, planes[p][1]], -planes[p][2], -1)
                       - wmsg(it, p, c2v[p]))
                for p in ps
            ])
            y = st_msg(excl_update(xs, it))
            for k, p in enumerate(ps):
                new[p] = y[k]
        return L, new

    def jax_flooding(Lc: list, c2v: list, it: int) -> list:
        """JAX's roll flooding iteration: per variable block the v2c are
        total − x with total = (wl ⊙) LLR + Σ x, x the (weighted) c2v in
        variable orientation, the sum one reduction."""
        v2c: list = [None] * P
        for j in range(nb):
            ps = group_v[j]
            x = torch.stack([torch.roll(wmsg(it, p, c2v[p]), planes[p][2],
                                        -1) for p in ps])
            lv = Lc[j] if wt is None else wt.llr[it, j] * Lc[j]
            total = lv + x.sum(0)
            for k, p in enumerate(ps):
                v2c[p] = torch.roll(total - x[k], -planes[p][2], -1)
        new: list = [None] * P
        for i in range(mb):
            ps = group_c[i]
            y = excl_update(torch.stack([v2c[p] for p in ps]), it)
            for k, p in enumerate(ps):
                new[p] = y[k]
        return new

    # internal convention log(Pr0/Pr1), variable-block layout (B, nb, z)
    Lv = st_post((-llr).to(torch.float32)).to(arith).reshape(B, nb, z)
    idx = torch.arange(B, device=dev)
    if done_in is not None:
        done_in = done_in.to(device=dev, dtype=torch.bool).reshape(B)
        idx = idx[~done_in]
    Lc = [Lv[idx, j] for j in range(nb)]  # the channel's planes
    c2v = [torch.zeros((idx.numel(), z), dtype=arith, device=dev)] * P
    # layered with weights starts from the posterior of the zero messages
    L = rebuild(Lc, c2v, 0) if wt is not None and schedule == "layered" \
        else Lc
    post = torch.zeros((B, nb, z), dtype=torch.float32, device=dev)
    iters = torch.full((B,), iterations, dtype=torch.int32, device=dev)

    if not early_stop:
        for it in range(iterations):
            L, c2v = iterate(L, c2v, it)
        post[idx] = posterior(L, c2v)
        return _emit(post, output, n, iters, qc)

    if done_in is not None:
        iters[done_in] = 0

    def retire(L, c2v, idx, count):
        """Freeze the codewords whose syndrome holds at this state."""
        p = posterior(L, c2v)
        ok = unsat_checks(p, qc) == 0
        post[idx[ok]] = p[ok]
        iters[idx[ok]] = count
        go = ~ok
        return [x[go] for x in L], [x[go] for x in c2v], idx[go]

    K = es_check_every
    if done_in is None:
        L, c2v, idx = retire(L, c2v, idx, 0)
    for r in range(iterations // K):
        if idx.numel() == 0:
            break
        for kk in range(K):
            L, c2v = iterate(L, c2v, r * K + kk)
        L, c2v, idx = retire(L, c2v, idx, (r + 1) * K)
    post[idx] = posterior(L, c2v)
    return _emit(post, output, n, iters, qc)


def _emit(post: torch.Tensor, output: str, n: int, iters: torch.Tensor,
          qc: QcStructure):
    """(B, nb, z) internal posterior log(Pr0/Pr1) → requested output."""
    B = post.shape[0]
    if output == "posterior":
        return (-post).reshape(B, n)
    bits = (post < 0).to(torch.int8).reshape(B, n)
    if output == "hard_iters":
        return bits, iters
    if output == "hard_unsat":
        return bits, unsat_checks(post, qc)
    return bits
