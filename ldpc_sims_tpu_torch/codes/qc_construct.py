"""Deterministic girth-aware QC-LDPC construction + shift-table loader.

Widens the code library along the QC fast path (roll/Pallas backends)
with higher-rate codes in the same structural family as 802.11n Annex R:
an (mb × nb) base matrix of circulant shifts whose parity part is the
standard dual-diagonal (encodable) pattern and whose information part is
chosen by a greedy progressive construction that avoids short cycles.

**Provenance note**: the literal IEEE 802.11n rate-2/3, 3/4, 5/6 and
3GPP 38.212 BG1/BG2 shift tables are NOT reproduced here — this build
environment has no network access and no copy of those standards, and
inventing table entries from memory would silently produce non-conformant
codes. Instead:

* :func:`make_qc_code` builds codes of the same family (same z, base
  shape, parity structure, comparable degree profiles) with a
  deterministic seeded construction — every decode-path property the
  framework exercises (QC rolls, layered schedules, trained schedules,
  rate behavior) is representative;
* :func:`load_qc_base` reads a shift table from a plain text file, so
  the conformant matrices drop in without code changes the moment a
  user supplies them (one integer row per base-matrix row, ``-1`` for
  a zero block, first line ``z``).

The 4-cycle condition used by the greedy search is the standard QC
lifting criterion: blocks (i1,j1),(i1,j2),(i2,j2),(i2,j1) all nonzero
form a length-4 cycle in the lifted graph iff
``(s[i1,j1] − s[i1,j2] + s[i2,j2] − s[i2,j1]) mod z == 0``
(Fossorier 2004). 6-cycles use the analogous 6-term alternating sum and
are avoided best-effort (high-rate bases are too dense to clear all).
"""

from __future__ import annotations

import numpy as np

from ldpc_sims_tpu_torch.codes import gf2
from ldpc_sims_tpu_torch.codes.library import LdpcCode, QcStructure
from ldpc_sims_tpu_torch.codes.wifi import expand_qc

__all__ = ["make_qc_code", "load_qc_base", "qc_from_base"]


def _pick_shift(base: np.ndarray, z: int, i: int, j: int,
                cands: np.ndarray) -> int | None:
    """Best shift for new entry (i, j): 4-cycle-free (mandatory) with the
    fewest new 6-cycles. Fully vectorized over candidates and cycle
    tuples (the Python-loop formulation is ~1000x slower).

    4-cycle through (i,j): some (i2, j2) with
    ``(s − base[i,j2] + base[i2,j2] − base[i2,j]) mod z == 0``.
    6-cycle: some (j2, i2, j3, i3), alternating sum of the six shifts.
    """
    mb, nb = base.shape
    valid = base >= 0
    C = cands.shape[0]
    # --- 4-cycles: tensor (C, mb, nb) over (i2, j2) -------------------
    ok2 = valid.copy()
    ok2[i, :] = False
    ok2[:, j] = False
    pair_ok = ok2 & valid[i, None, :] & valid[:, j][:, None]
    # (s − base[i,j2] + base[i2,j2] − base[i2,j]) mod z
    delta4 = (-base[i, None, :] + base - base[:, j][:, None])  # (mb, nb)
    four = (cands[:, None, None] + delta4[None]) % z == 0
    has4 = np.any(four & pair_ok[None], axis=(1, 2))  # (C,)
    if np.all(has4):
        return None
    # --- 6-cycles: tensor (C, nb, mb, nb, mb) over (j2, i2, j3, i3) ---
    a = (cands[:, None] - base[i][None]) % z  # (C, nb) via j2
    a_ok = valid[i] & (np.arange(nb) != j)
    d2 = (base[:, :, None] - base[:, None, :])  # (mb, j2, j3)
    d2_ok = valid[:, :, None] & valid[:, None, :]
    c = (base - base[:, j][:, None])  # (i3, j3): base[i3,j3] − base[i3,j]
    c_ok = valid & valid[:, j][:, None]
    # index masks
    i_ok = np.arange(mb) != i
    j_ok = np.arange(nb) != j
    # total[C, j2, i2, j3, i3]
    d2_t = d2.transpose(1, 0, 2)  # (j2, i2, j3)
    d2_ok_t = d2_ok.transpose(1, 0, 2)
    c_t, c_ok_t = c.T, c_ok.T  # (j3, i3)
    tot = (
        a[:, :, None, None, None]
        + d2_t[None, :, :, :, None]
        + c_t[None, None, None, :, :]
    ) % z
    ok = (
        a_ok[None, :, None, None, None]
        & d2_ok_t[None, :, :, :, None]
        & c_ok_t[None, None, None, :, :]
        & i_ok[None, None, :, None, None]   # i2 != i
        & i_ok[None, None, None, None, :]   # i3 != i
        & j_ok[None, :, None, None, None]   # j2 != j
        & j_ok[None, None, None, :, None]   # j3 != j
        & (np.arange(mb)[None, None, :, None, None]
           != np.arange(mb)[None, None, None, None, :])  # i2 != i3
        & (np.arange(nb)[None, :, None, None, None]
           != np.arange(nb)[None, None, None, :, None])  # j2 != j3
    )
    six = np.sum((tot == 0) & ok, axis=(1, 2, 3, 4))  # (C,)
    six = np.where(has4, np.iinfo(np.int64).max, six)
    return int(cands[int(np.argmin(six))])


def make_qc_code(
    z: int,
    mb: int,
    nb: int = 24,
    info_col_degree: int = 3,
    seed: int = 0,
    name: str | None = None,
    six_cycle_budget: int = 64,
) -> LdpcCode:
    """Girth-aware QC-LDPC code, 802.11n-family structure.

    Parity part (last ``mb`` block columns): the Annex-R dual-diagonal
    pattern — column nb−mb carries shifts (1, 0, 1) at rows
    (0, mb//2, mb−1), the remaining parity columns carry 0/0 pairs on
    the staircase — so the code is systematically encodable and H is
    full rank by construction. Information part: each column gets
    ``info_col_degree`` entries on the currently least-loaded rows;
    shifts are drawn seeded-uniformly and accepted only if 4-cycle-free
    (mandatory) with the fewest new 6-cycles among
    ``six_cycle_budget`` candidates.

    Rate = (nb − mb)/nb: mb=12 → 1/2, mb=8 → 2/3, mb=6 → 3/4,
    mb=4 → 5/6 at nb=24 (the 802.11n geometry).
    """
    rng = np.random.default_rng(seed)
    base = -np.ones((mb, nb), dtype=np.int64)
    p0 = nb - mb
    # dual-diagonal parity part
    base[0, p0] = 1
    base[mb // 2, p0] = 0
    base[mb - 1, p0] = 1
    for kcol in range(1, mb):
        base[kcol - 1, p0 + kcol] = 0
        base[kcol, p0 + kcol] = 0
    # information part, column by column
    for j in range(p0):
        row_load = np.array([(base[i] >= 0).sum() for i in range(mb)])
        # spread entries over the least-loaded rows, deterministic ties
        order = np.lexsort((np.arange(mb), row_load))
        rows = sorted(order[:info_col_degree].tolist())
        for i in rows:
            cands = rng.permutation(z)[:six_cycle_budget]
            s = _pick_shift(base, z, i, j, cands)
            if s is None:  # pragma: no cover - dense corner
                # no 4-cycle-free candidate: take any shift (the code
                # stays full-rank/encodable, just lower girth here)
                s = int(rng.integers(z))
            base[i, j] = s
    return qc_from_base(
        base, z,
        name=name or f"qc{nb * z}_r{nb - mb}{nb}s{seed}",
    )


def qc_from_base(base, z: int, name: str) -> LdpcCode:
    """Shift base matrix → LdpcCode with QC structure (rank-checked)."""
    base = np.asarray(base, dtype=np.int64)
    H = expand_qc(base, z)
    if gf2.rank(H) != H.shape[0]:
        raise ValueError(
            f"base matrix expands to rank-deficient H for {name}"
        )
    qc = QcStructure(z=z, base=tuple(tuple(int(s) for s in r) for r in base))
    return LdpcCode(name=name, H=H, qc=qc)


def load_qc_base(path: str, name: str | None = None) -> LdpcCode:
    """Load a QC shift table from a text file.

    Format: first non-comment line is ``z``; each following line is one
    base-matrix row of whitespace-separated integers (−1 = zero block).
    This is the drop-in point for conformant standard tables (802.11n
    Annex R, 3GPP 38.212 BG1/BG2 after lifting-set selection) — see the
    module provenance note.
    """
    rows: list[list[int]] = []
    z = None
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [int(v) for v in line.split()]
            if z is None:
                if len(vals) != 1:
                    raise ValueError("first line must be a single z value")
                z = vals[0]
            else:
                rows.append(vals)
    if z is None or not rows:
        raise ValueError(f"no shift table found in {path}")
    if any(len(r) != len(rows[0]) for r in rows):
        raise ValueError("ragged base matrix")
    import os

    return qc_from_base(
        rows, z, name=name or os.path.splitext(os.path.basename(path))[0]
    )
