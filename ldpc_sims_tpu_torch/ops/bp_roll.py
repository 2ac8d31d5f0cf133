"""Plain PyTorch QC-LDPC min-sum decode: the port of ``ops/bp_roll.py``.

This module is the plain version of both CUDA decode kernels
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

Scope: min-sum with scalar or per-iteration (tuple) α/β, optional clamp,
flooding and layered (serial-C) schedules, outputs ``hard`` and
``posterior``. :func:`..ops.bp.bp_decode` rejects what the JAX function
takes beyond that, naming its ROADMAP item.
"""

from __future__ import annotations

import torch

from ldpc_sims_tpu_torch.codes.library import QcStructure

__all__ = ["decode_roll", "qc_plan"]

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
):
    """QC-LDPC min-sum decode; the contract of :func:`..ops.bp.bp_decode`
    for QC codes, outputs 'hard' (int8 bits) and 'posterior'.

    llr: (batch, n) channel LLRs, log(Pr1/Pr0) convention, on any device.
    ``alpha``/``beta`` may be length-``iterations`` tuples (a frozen
    per-iteration normalization/offset schedule).

    ``schedule='flooding'``: each iteration rebuilds the posterior as
    LLR + Σ c2v in check-sorted order, forms v2c = roll(post, −s) − c2v
    and updates every check. ``schedule='layered'``: serial-C over the mb
    block rows, each row reading the current posterior and folding its
    message change back into it.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if output not in ("hard", "posterior"):
        raise ValueError(f"unknown output {output!r}")
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
    for arr, name in ((ms_a, "alpha"), (ms_b, "beta")):
        if arr is not None and arr.shape != (iterations,):
            raise ValueError(
                f"per-iteration {name} must have shape ({iterations},), "
                f"got {tuple(arr.shape)}"
            )

    def excl_update(x: torch.Tensor, it: int) -> torch.Tensor:
        a = alpha if ms_a is None else ms_a[it]
        b = beta if ms_b is None else ms_b[it]
        y = _minsum_excl(x, a, b)
        if clamp is not None:
            y = torch.clamp(y, -clamp, clamp)
        return y

    # internal convention log(Pr0/Pr1), variable-block layout (B, nb, z)
    Lv = (-llr).to(torch.float32).reshape(B, nb, z)
    c2v = [torch.zeros((B, z), dtype=torch.float32, device=dev)] * P

    if schedule == "layered":
        L = [Lv[:, j] for j in range(nb)]
        for it in range(iterations):
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
        return _emit(torch.stack(L, 1), output, n)

    def posterior(c2v: list) -> torch.Tensor:
        rows = []
        for j in range(nb):
            acc = Lv[:, j]
            for p in group_v[j]:
                acc = acc + torch.roll(c2v[p], planes[p][2], -1)
            rows.append(acc)
        return torch.stack(rows, 1)  # (B, nb, z)

    for it in range(iterations):
        post = posterior(c2v)
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
        c2v = new
    return _emit(posterior(c2v), output, n)


def _emit(post: torch.Tensor, output: str, n: int):
    """(B, nb, z) internal posterior log(Pr0/Pr1) → requested output."""
    B = post.shape[0]
    if output == "posterior":
        return (-post).reshape(B, n)
    return (post < 0).to(torch.int8).reshape(B, n)
