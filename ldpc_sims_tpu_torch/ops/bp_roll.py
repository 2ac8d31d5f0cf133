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

Scope: min-sum with scalar or per-iteration (tuple) α/β and the stable
log-domain sum-product, optional clamp and message quantization
(``msg_qbits``), flooding and layered (serial-C) schedules, per-codeword
early stop with a check stride, a mask of codewords to skip, and the
outputs ``hard``, ``posterior``, ``hard_iters`` and ``hard_unsat``.
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

import torch

from ldpc_sims_tpu_torch.codes.library import QcStructure

__all__ = ["decode_roll", "msg_qstep", "qc_plan", "unsat_checks"]

_BIG = 1e30


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


def msg_qstep(msg_qbits: int | None, msg_qclip: float) -> float | None:
    """The message quantization step ``2·msg_qclip/(2**msg_qbits − 1)``,
    or None without quantization."""
    if msg_qbits is None:
        return None
    if int(msg_qbits) != msg_qbits or msg_qbits < 1 or not msg_qclip > 0:
        raise ValueError(f"msg_qbits={msg_qbits!r} must be a positive "
                         f"integer and msg_qclip={msg_qclip!r} positive")
    return 2.0 * msg_qclip / (2**int(msg_qbits) - 1)


def _exclusive_sign(x: torch.Tensor) -> torch.Tensor:
    """Exclusive sign product over dim 0 as a negative-count parity.

    A strict ``x < 0`` test: −0.0 counts as positive, as in the kernels.
    """
    neg = (x < 0).to(x.dtype)
    ex = neg.sum(0, keepdim=True) - neg
    return 1.0 - 2.0 * torch.remainder(ex, 2.0)


def _minsum_excl(x: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Exclusive min-sum over dim 0 of (d, B, z) via two minima:
    ``exsign · max(exmin − β, 0) · α``."""
    a = x.abs()
    min1, idx = a.min(0, keepdim=True)  # first index of the minimum
    onehot = torch.arange(x.shape[0], device=x.device).view(-1, 1, 1) == idx
    min2 = torch.where(onehot, _BIG, a).amin(0, keepdim=True)
    exmin = torch.where(onehot, min2, min1)
    exsign = _exclusive_sign(x)
    return exsign * torch.clamp_min(exmin - beta, 0.0) * alpha


def _sumproduct_excl(x: torch.Tensor) -> torch.Tensor:
    """Stable exclusive sum-product over dim 0 of (d, B, z), the JAX roll
    backend's ``expm1``/``log1p`` form: ``a = max(|x|, 1e-12)``,
    ``lt = log(−expm1(−a)) − log1p(exp(−a))``, ``s = min(Σlt − lt,
    −1e-12)``, magnitude ``log1p(exp(s)) − log(−expm1(s))`` (at most
    28.3). The row sum runs left to right over the slots, as the kernels
    take it."""
    a = torch.clamp_min(x.abs(), 1e-12)
    lt = torch.log(-torch.expm1(-a)) - torch.log1p(torch.exp(-a))
    total = torch.zeros_like(lt[0])
    for k in range(lt.shape[0]):
        total = total + lt[k]
    s = torch.clamp_max(total - lt, -1e-12)
    mag = torch.log1p(torch.exp(s)) - torch.log(-torch.expm1(s))
    return _exclusive_sign(x) * mag


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
):
    """QC-LDPC BP decode; the contract of :func:`..ops.bp.bp_decode` for
    QC codes, and of the Pallas kernel's early-stop forms.

    llr: (batch, n) channel LLRs, log(Pr1/Pr0) convention, on any device.
    ``method``: 'min-sum' or 'sum-product'. Min-sum's ``alpha``/``beta``
    may be length-``iterations`` tuples (a frozen per-iteration
    normalization/offset schedule); sum-product ignores scalar α/β and
    rejects tuples. Each c2v message is clamped to ±``clamp``, then with
    ``msg_qbits`` rounded to the step ``2·msg_qclip/(2**msg_qbits − 1)``
    (half to even, after a true division) and clipped to ±``msg_qclip``.

    ``schedule='flooding'``: each iteration rebuilds the posterior as
    LLR + Σ c2v in check-sorted order, forms v2c = roll(post, −s) − c2v
    and updates every check. ``schedule='layered'``: serial-C over the mb
    block rows, each row reading the current posterior and folding its
    message change back into it.

    ``early_stop``: each codeword freezes at its first syndrome-satisfying
    state, checked on the channel decisions at entry and after every
    ``es_check_every``-th iteration (K must divide ``iterations``); its
    iteration count is 0 at entry, (r+1)·K at the r-th check, and
    ``iterations`` if it never converges. ``done_in``: optional (batch,)
    mask of codewords that are not decoded at all; their output is
    unspecified (zeros here) and, under early stop, their count is 0,
    and the others skip the entry check.

    Outputs: 'hard' (int8 bits), 'posterior' (f32), 'hard_iters'
    ((bits, iters), iters constant without early stop) and 'hard_unsat'
    ((bits, unsat): the count of unsatisfied checks per codeword after a
    fixed decode; not with early stop).
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if method not in ("min-sum", "sum-product"):
        raise ValueError(f"unknown method {method!r}")
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

    ms_a = ms_b = None
    if isinstance(alpha, (tuple, list)):
        ms_a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    if isinstance(beta, (tuple, list)):
        ms_b = torch.tensor(beta, dtype=torch.float32, device=dev)
    if (ms_a is not None or ms_b is not None) and method != "min-sum":
        raise ValueError("per-iteration alpha/beta require min-sum")
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
        qstep = torch.tensor(qstep, dtype=torch.float32, device=dev)

    def excl_update(x: torch.Tensor, it: int) -> torch.Tensor:
        if method == "min-sum":
            a = alpha if ms_a is None else ms_a[it]
            b = beta if ms_b is None else ms_b[it]
            y = _minsum_excl(x, a, b)
        else:
            y = _sumproduct_excl(x)
        if clamp is not None:
            y = torch.clamp(y, -clamp, clamp)
        if qstep is not None:
            y = torch.clamp(torch.round(y / qstep) * qstep, -msg_qclip,
                            msg_qclip)
        return y

    # The state of the codewords still being decoded: L (nb planes of
    # (b, z), variable orientation) and c2v (P planes, check orientation).
    # Layered keeps the running posterior in L; flooding keeps the channel
    # LLRs there and rebuilds the posterior from c2v. Every operation is
    # per codeword, so decoding a subset of the rows changes no row.
    def posterior(L: list, c2v: list) -> torch.Tensor:
        if schedule == "layered":
            return torch.stack(L, 1)
        rows = []
        for j in range(nb):
            acc = L[j]
            for p in group_v[j]:
                acc = acc + torch.roll(c2v[p], planes[p][2], -1)
            rows.append(acc)
        return torch.stack(rows, 1)  # (b, nb, z)

    def iterate(L: list, c2v: list, it: int) -> tuple[list, list]:
        if schedule == "layered":
            L, c2v = list(L), list(c2v)
            for i in range(mb):
                ps = group_c[i]
                xs = torch.stack([
                    torch.roll(L[planes[p][1]], -planes[p][2], -1) - c2v[p]
                    for p in ps
                ])
                y = excl_update(xs, it)
                for k, p in enumerate(ps):
                    _, j, s = planes[p]
                    L[j] = L[j] + torch.roll(y[k] - c2v[p], s, -1)
                    c2v[p] = y[k]
            return L, c2v
        post = posterior(L, c2v)
        new: list = [None] * P
        for i in range(mb):
            ps = group_c[i]
            xs = torch.stack([
                torch.roll(post[:, planes[p][1]], -planes[p][2], -1) - c2v[p]
                for p in ps
            ])
            y = excl_update(xs, it)
            for k, p in enumerate(ps):
                new[p] = y[k]
        return L, new

    # internal convention log(Pr0/Pr1), variable-block layout (B, nb, z)
    Lv = (-llr).to(torch.float32).reshape(B, nb, z)
    idx = torch.arange(B, device=dev)
    if done_in is not None:
        done_in = done_in.to(device=dev, dtype=torch.bool).reshape(B)
        idx = idx[~done_in]
    L = [Lv[idx, j] for j in range(nb)]
    c2v = [torch.zeros((idx.numel(), z), dtype=torch.float32,
                       device=dev)] * P
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
