"""Bit-packed GF(2) linear algebra (NumPy, host-side, build-time only).

Used to derive systematic generator matrices from arbitrary parity-check
matrices. The reference hardcodes its generator for the one (64,32) code
whose parity part is the identity (``bp/parity.py:42-44``); this module
generalizes that to any full-row-rank H via packed Gaussian elimination,
so the 802.11n and PEG codes get systematic encoders too.

Everything here runs once per code at graph-construction time on the host;
the results are baked into jitted device programs as constants.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pack_rows",
    "unpack_rows",
    "row_echelon",
    "rank",
    "systematic_form",
    "generator_from_H",
]


def pack_rows(a: np.ndarray) -> np.ndarray:
    """Pack a (m, n) 0/1 matrix into (m, ceil(n/64)) uint64 rows."""
    a = np.asarray(a, dtype=np.uint8) & 1
    m, n = a.shape
    pad = (-n) % 64
    if pad:
        a = np.concatenate([a, np.zeros((m, pad), dtype=np.uint8)], axis=1)
    bits = a.reshape(m, -1, 64)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[None, None, :]
    return (bits.astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)


def unpack_rows(p: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`."""
    m, _ = p.shape
    shifts = np.arange(64, dtype=np.uint64)[None, None, :]
    bits = (p[:, :, None] >> shifts) & np.uint64(1)
    return bits.reshape(m, -1)[:, :n].astype(np.uint8)


def row_echelon(
    H: np.ndarray, col_order: list[int] | None = None
) -> tuple[np.ndarray, list[int]]:
    """Reduced row echelon form over GF(2).

    Returns ``(R, pivot_cols)`` where R is the RREF of H (dense uint8) and
    ``pivot_cols`` the pivot column indices in the order they were chosen.
    ``col_order`` controls pivot preference (default: left to right).
    """
    H = np.asarray(H, dtype=np.uint8) & 1
    m, n = H.shape
    P = pack_rows(H)
    pivots: list[int] = []
    r = 0
    for col in col_order if col_order is not None else range(n):
        if r >= m:
            break
        word, bit = divmod(col, 64)
        mask = np.uint64(1) << np.uint64(bit)
        rows_with_bit = np.nonzero((P[r:, word] & mask) != 0)[0]
        if rows_with_bit.size == 0:
            continue
        pivot = r + int(rows_with_bit[0])
        if pivot != r:
            P[[r, pivot]] = P[[pivot, r]]
        # eliminate this column from every other row
        has_bit = (P[:, word] & mask) != 0
        has_bit[r] = False
        P[has_bit] ^= P[r]
        pivots.append(col)
        r += 1
    return unpack_rows(P, n), pivots


def rank(H: np.ndarray) -> int:
    return len(row_echelon(H)[1])


def systematic_form(H: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Column permutation putting H into systematic form ``[A | I]``.

    Returns ``(perm, A)`` with ``perm`` a length-n permutation such that
    ``H[:, perm]`` row-reduces to ``[A | I_m]`` (identity on the *last* m
    columns — the permuted-last columns are the parity positions), and
    ``A`` the (m, k) left block of the reduced matrix whose row r matches
    the r-th entry of the pivot (parity) half of ``perm``.

    Pivots are preferred in the *rightmost* columns so that for codes whose
    parity part already sits on the right (the reference ``[P | I]`` code,
    802.11n) the info positions come out as 0..k-1, matching the
    reference's "info bits = first k positions" convention
    (``evaluate_snr.py`` computes coded BER on ``[:, 0:k]``).

    Raises if H is row-rank deficient (rows should be pre-reduced instead).
    """
    H = np.asarray(H, dtype=np.uint8) & 1
    m, n = H.shape
    R, pivots = row_echelon(H, col_order=list(range(n - 1, -1, -1)))
    if len(pivots) != m:
        raise ValueError(
            f"H has row rank {len(pivots)} < m={m}; remove dependent rows first"
        )
    pivots_arr = np.array(pivots)
    non_pivots = np.setdiff1d(np.arange(n), pivots_arr)  # ascending
    perm = np.concatenate([non_pivots, pivots_arr])
    A = R[:, non_pivots]
    return perm, A


def generator_from_H(H: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Systematic generator for the code defined by H.

    Returns ``(G, perm)``: G is (n, k) with ``G = [[I_k], [A]]`` in the
    *permuted* coordinate system, and ``perm`` maps permuted positions back
    to original codeword positions: a codeword is
    ``c[perm] = G @ u (mod 2)``, i.e. ``c = scatter(G @ u, perm)``.
    Satisfies ``H @ c == 0 (mod 2)`` for every info word u.

    For H already of the form ``[P | I]`` (like the reference code,
    ``bp/parity.py:42-44``) the info positions come out as 0..k-1 and the
    parity bits are uniquely determined, so encoding agrees bit-for-bit
    with the reference's ``G = transpose([I | Pᵀ]) = [I ; P]``.
    """
    perm, A = systematic_form(H)
    m, k = A.shape
    G = np.concatenate([np.eye(k, dtype=np.uint8), A], axis=0)
    return G, perm
