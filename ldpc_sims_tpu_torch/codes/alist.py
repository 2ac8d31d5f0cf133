"""alist format I/O (MacKay's sparse parity-check interchange format).

The de-facto interchange format for LDPC matrices (used by MacKay's code
database and most decoder toolkits). The reference has no loader at all —
its single matrix is a hardcoded literal (``bp/parity.py:7-40``); this
makes external codes loadable.

Format: line 1 ``n m``; line 2 ``max_col_deg max_row_deg``; line 3 the n
column degrees; line 4 the m row degrees; then n lines of 1-based check
indices per column (zero-padded to max_col_deg allowed); then m lines of
1-based variable indices per row.
"""

from __future__ import annotations

import io

import numpy as np

from ldpc_sims_tpu_torch.codes.library import LdpcCode

__all__ = ["load_alist", "save_alist", "loads_alist", "dumps_alist"]


def loads_alist(text: str) -> np.ndarray:
    toks = text.split()
    it = iter(toks)

    def nxt() -> int:
        return int(next(it))

    n, m = nxt(), nxt()
    max_cd, _max_rd = nxt(), nxt()
    col_deg = [nxt() for _ in range(n)]
    row_deg = [nxt() for _ in range(m)]
    H = np.zeros((m, n), dtype=np.uint8)
    for v in range(n):
        # entries may be padded with zeros up to max_cd; read col_deg then
        # tolerate either padded or unpadded files by peeking counts
        count = 0
        entries = []
        while count < col_deg[v]:
            e = nxt()
            if e > 0:
                entries.append(e)
                count += 1
        H[[e - 1 for e in entries], v] = 1
    # row lists are redundant; consume if present and cross-check
    remaining = list(it)
    if remaining:
        pos = 0
        for c in range(m):
            got = []
            while len(got) < row_deg[c] and pos < len(remaining):
                e = int(remaining[pos])
                pos += 1
                if e > 0:
                    got.append(e)
            if sorted(got) != list((np.nonzero(H[c])[0] + 1)):
                raise ValueError(f"alist row {c} inconsistent with columns")
    return H


def load_alist(path: str, name: str | None = None) -> LdpcCode:
    with open(path) as f:
        H = loads_alist(f.read())
    return LdpcCode(name=name or path.rsplit("/", 1)[-1], H=H)


def dumps_alist(H: np.ndarray) -> str:
    H = np.asarray(H, dtype=np.uint8) & 1
    m, n = H.shape
    col = [np.nonzero(H[:, v])[0] + 1 for v in range(n)]
    row = [np.nonzero(H[c, :])[0] + 1 for c in range(m)]
    buf = io.StringIO()
    buf.write(f"{n} {m}\n")
    buf.write(f"{max(len(c) for c in col)} {max(len(r) for r in row)}\n")
    buf.write(" ".join(str(len(c)) for c in col) + "\n")
    buf.write(" ".join(str(len(r)) for r in row) + "\n")
    for c in col:
        buf.write(" ".join(map(str, c)) + "\n")
    for r in row:
        buf.write(" ".join(map(str, r)) + "\n")
    return buf.getvalue()


def save_alist(path: str, code: LdpcCode | np.ndarray) -> None:
    H = code.H if isinstance(code, LdpcCode) else code
    with open(path, "w") as f:
        f.write(dumps_alist(H))
