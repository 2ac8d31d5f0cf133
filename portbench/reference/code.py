"""A QC-LDPC code from its base matrix: the parity-check edges and a
systematic encoder, in NumPy and plain PyTorch.

Block (i, j) of the base matrix with shift s >= 0 is the z x z identity
shifted right by s: it joins check ``i*z + r`` to variable
``j*z + (r + s) mod z``. The encoder puts the info bits at positions
[0, k) and solves ``H_p p = H_s u`` over GF(2) for the parity at [k, n).
"""

from __future__ import annotations

import numpy as np
import torch


class Code:
    """The edges of H in two padded layouts, and the parity generator.

    ``check_slots`` (m, dc) holds the edge ids of each check, its
    variables in ascending order, padded with ``E``; ``var_slots`` (n, dv)
    the edge ids of each variable, its checks in ascending order, padded
    with ``E``. Edge e joins ``edge_check[e]`` and ``edge_var[e]``; edges
    are numbered check by check.
    """

    def __init__(self, base, z: int, k: int):
        base = np.asarray(base, dtype=np.int64)
        self.mb, self.nb = base.shape
        self.z = z
        self.m, self.n = self.mb * z, self.nb * z
        self.k = k
        if self.n - self.m != k:
            raise ValueError(f"k={k} is not n - m = {self.n - self.m}")
        checks, vars_ = [], []
        for i in range(self.mb):
            for r in range(z):
                for j in range(self.nb):
                    s = base[i, j]
                    if s >= 0:
                        checks.append(i * z + r)
                        vars_.append(j * z + (r + s) % z)
        self.edge_check = np.asarray(checks, np.int64)
        self.edge_var = np.asarray(vars_, np.int64)
        self.E = len(checks)
        self.check_slots = _pad_groups(self.edge_check, self.m, self.E)
        # edges in check order, so a variable's edges are in check order
        self.var_slots = _pad_groups(self.edge_var, self.n, self.E)
        # the block row of each check, for layered schedules
        self.block_rows = [np.arange(i * z, (i + 1) * z)
                           for i in range(self.mb)]
        self._parity = None

    def H(self) -> np.ndarray:
        h = np.zeros((self.m, self.n), np.uint8)
        h[self.edge_check, self.edge_var] = 1
        return h

    def parity_generator(self) -> np.ndarray:
        """(m, k) 0/1 matrix P with parity = P u mod 2."""
        if self._parity is None:
            h = self.H()
            self._parity = _solve_gf2(h[:, self.k:], h[:, :self.k])
        return self._parity

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """(B, k) int8 info bits -> (B, n) int8 codewords, on u's device.
        The parity is an f32 product of 0/1 matrices with TF32 off: every
        sum is an integer at most k < 2^24, so it is exact."""
        P = torch.from_numpy(self.parity_generator().T.astype(np.float32))
        P = P.to(u.device)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            s = torch.matmul(u.to(torch.float32), P)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        parity = (s.to(torch.int32) & 1).to(torch.int8)
        return torch.cat([u.to(torch.int8), parity], dim=1)


def _pad_groups(owner: np.ndarray, count: int, pad: int) -> np.ndarray:
    """(count, width) edge ids grouped by ``owner``, in edge order, padded
    with ``pad``."""
    order = np.argsort(owner, kind="stable")
    sizes = np.bincount(owner, minlength=count)
    out = np.full((count, int(sizes.max())), pad, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for g in range(count):
        out[g, :sizes[g]] = order[starts[g]:starts[g] + sizes[g]]
    return out


def _solve_gf2(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """X with A X = B over GF(2), A square and invertible: Gauss-Jordan
    on [A | B] with rows packed into bytes."""
    m = A.shape[0]
    aug = np.packbits(np.concatenate([A, B], axis=1).astype(np.uint8),
                      axis=1)
    for c in range(m):
        col = (aug[:, c >> 3] >> (7 - (c & 7))) & 1
        rows = np.nonzero(col[c:])[0]
        if rows.size == 0:
            raise ValueError("the parity part of H is singular")
        p = c + rows[0]
        if p != c:
            aug[[c, p]] = aug[[p, c]]
            col[[c, p]] = col[[p, c]]
        hit = np.nonzero(col)[0]
        hit = hit[hit != c]
        aug[hit] ^= aug[c]
    full = np.unpackbits(aug, axis=1)[:, :A.shape[1] + B.shape[1]]
    return full[:, m:]
