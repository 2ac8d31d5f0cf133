"""Protograph density evolution: asymptotic thresholds for every QC code
(the port of ``codes/de.py``).

The decoding threshold of the (infinite-length) protograph ensemble
depends only on the base matrix and the check rule, and a finite-length
waterfall must sit a small, predictable gap above it: the external check
of a committed curve, which paired self-consistency checks cannot give.

Method: **sampled (Monte-Carlo) density evolution on the protograph**.
Each base-matrix entry (i, j) ≥ 0 is an edge type (a *plane*); message
distributions are populations of ``samples`` values. One DE iteration
(all-zero codeword, BPSK over AWGN, ``snr = 1/σ²``):

* channel LLRs of each variable type drawn fresh: N(2/σ², 4/σ²)
  (positive = correct);
* v2c populations: exclusive column sums over the producers'
  populations, each randomly permuted (independence across types is
  restored by re-shuffling at every use);
* c2v populations: the exact exclusive check rule over the row, the
  decoder's own ``_minsum_excl`` / ``_sumproduct_excl``
  (``ops/bp_roll.py``), so the threshold is of this implementation,
  clamps, α/β and all.

On a device the planes are one ``(P, samples)`` tensor: a fresh,
independent permutation of every plane's population is one
``argsort(rand(P, samples))`` and a ``gather``, the column sums one
``index_add_``, and the check rule one call for each group of rows of
equal degree, so an iteration is a few dozen launches whatever the
number of planes. The JAX package draws from ``jax.random`` and
unrolls its loops over planes; the function and the distribution of its
result are the same, the random streams are not.

:func:`de_threshold` bisects SNR to the smallest value whose final error
probability falls below ``eps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ldpc_sims_tpu_torch.ops.bp_roll import _minsum_excl, _sumproduct_excl
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["protograph_de_error", "de_threshold"]

_METHODS = ("min-sum", "sum-product")


def _plan(base: np.ndarray):
    """Edge types + per-row / per-column groupings of a base matrix."""
    base = np.asarray(base)
    planes = [
        (i, j)
        for i in range(base.shape[0])
        for j in range(base.shape[1])
        if base[i, j] >= 0
    ]
    rows: list[list[int]] = [[] for _ in range(base.shape[0])]
    cols: list[list[int]] = [[] for _ in range(base.shape[1])]
    for p, (i, j) in enumerate(planes):
        rows[i].append(p)
        cols[j].append(p)
    return planes, rows, cols


def _de_run(snr_db: float, base: np.ndarray, method: str, alpha: float,
            beta: float, clamp, iterations: int, samples: int, seed: int,
            dev: torch.device) -> float:
    """The mean posterior error probability over the variable types after
    ``iterations`` DE iterations (one generator, seeded with ``seed``)."""
    planes, rows, _ = _plan(base)
    P, nb, S = len(planes), base.shape[1], samples
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    # each plane's column, and the rows grouped by degree as (R, d) plane
    # indices: one check-rule call a group
    pcol = torch.tensor([j for _, j in planes], dtype=torch.long,
                        device=dev)
    by_degree: dict[int, list[list[int]]] = {}
    for ps in rows:
        if ps:
            by_degree.setdefault(len(ps), []).append(ps)
    groups = [torch.tensor(g, dtype=torch.long, device=dev)
              for _, g in sorted(by_degree.items())]
    sigma2 = 1.0 / 10.0 ** (snr_db / 10.0)

    def chan() -> torch.Tensor:
        # mean 2/σ², variance 4/σ² (positive = correct)
        return 2.0 / sigma2 + 2.0 / math.sqrt(sigma2) * torch.randn(
            (nb, S), generator=gen, device=dev)

    def shuffle(x: torch.Tensor) -> torch.Tensor:
        # an independent permutation of every plane's population
        keys = torch.rand((P, S), generator=gen, device=dev)
        return torch.gather(x, 1, torch.argsort(keys, dim=1))

    def check(x: torch.Tensor) -> torch.Tensor:
        # x: (d, R, S), the rule over dim 0
        if method == "min-sum":
            y = _minsum_excl(x, alpha, beta)
        else:
            y = _sumproduct_excl(x, serial=False)
        return y if clamp is None else torch.clamp(y, -clamp, clamp)

    c2v = torch.zeros((P, S), device=dev)
    for _ in range(iterations):
        L = chan()
        # variable side: exclusive column sums over shuffled producers
        shuf = shuffle(c2v)
        tot = L.index_add(0, pcol, shuf)
        # check side: the decoder's exclusive rule over each row
        v2c = shuffle(tot[pcol] - shuf)
        new = torch.empty_like(c2v)
        for idx in groups:
            new[idx] = check(v2c[idx].transpose(0, 1)).transpose(0, 1)
        c2v = new
    # posterior error probability per variable type, then the mean
    post = chan().index_add(0, pcol, shuffle(c2v))
    return float((post < 0).to(torch.float32).mean(1).mean())


def protograph_de_error(
    base,
    snr_db: float,
    method: str = "min-sum",
    alpha: float = 1.0,
    beta: float = 0.0,
    clamp: float | None = None,
    iterations: int = 200,
    samples: int = 1 << 14,
    seed: int = 0,
    device="cuda",
) -> float:
    """Asymptotic bit-error probability of the protograph ensemble at
    ``snr_db`` (``snr = 1/σ²``, BPSK) after ``iterations`` DE iterations,
    computed on ``device``. ~0 above threshold, bounded away from 0 below
    it."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    base = np.asarray(base, dtype=np.int64)
    with torch.no_grad():
        return _de_run(float(snr_db), base, method, float(alpha),
                       float(beta), clamp, iterations, samples, seed,
                       resolve_device(device))


def de_threshold(
    base,
    method: str = "min-sum",
    alpha: float = 1.0,
    beta: float = 0.0,
    clamp: float | None = None,
    snr_lo_db: float = -2.0,
    snr_hi_db: float = 6.0,
    tol_db: float = 0.05,
    eps: float = 1e-4,
    iterations: int = 200,
    samples: int = 1 << 14,
    seed: int = 0,
    device="cuda",
) -> float:
    """Decoding threshold (dB, ``snr = 1/σ²``) of the protograph ensemble
    under the given check rule: the smallest SNR whose DE error
    probability falls below ``eps``. Bisection to ``tol_db``; raises
    ``ValueError`` when DE does not converge at ``snr_hi_db``.

    Known anchor: the (3,6)-regular ensemble under sum-product has
    σ* = 0.8797 → 10·log10(1/σ*²) = 1.11 dB.
    """
    kw = dict(method=method, alpha=alpha, beta=beta, clamp=clamp,
              iterations=iterations, samples=samples, seed=seed,
              device=device)
    lo, hi = float(snr_lo_db), float(snr_hi_db)
    if protograph_de_error(base, hi, **kw) > eps:
        raise ValueError(
            f"DE does not converge even at {hi} dB; raise snr_hi_db"
        )
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if protograph_de_error(base, mid, **kw) <= eps:
            hi = mid
        else:
            lo = mid
    return hi
