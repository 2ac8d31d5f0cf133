"""Code analysis: degree profiles, QC cycle spectra, threshold hooks (the
port's NumPy copy of ``codes/analyze.py``).

The validation tool for imported codes: degree distributions, the QC 4-
and 6-cycle spectrum of the lifted graph (girth evidence) and, with
:mod:`.de`, the ensemble decoding thresholds. Exposed as ``cli
code-info``.
"""

from __future__ import annotations

import numpy as np

from ldpc_sims_tpu_torch.codes.library import LdpcCode

__all__ = ["degree_profile", "qc_cycle_counts", "code_report"]


def degree_profile(H: np.ndarray) -> dict:
    """Row/column degree histograms of a parity-check matrix."""
    H = np.asarray(H) != 0
    row = H.sum(axis=1)
    col = H.sum(axis=0)

    def hist(d):
        vals, cnts = np.unique(d, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, cnts)}

    return {
        "row_degrees": hist(row),
        "col_degrees": hist(col),
        "edges": int(H.sum()),
    }


def qc_cycle_counts(base, z: int) -> dict:
    """4- and 6-cycle counts of the LIFTED graph from the QC base.

    Fossorier's condition: an alternating closed walk through base
    entries lifts to ``z`` distinct cycles iff its alternating shift sum
    is 0 mod z (and to none otherwise). 4-cycles enumerate row pairs ×
    column pairs; 6-cycles the 6-entry closed walks over row triples ×
    column triples (each counted once).
    """
    base = np.asarray(base, dtype=np.int64)
    mb, _ = base.shape
    valid = base >= 0
    four = 0
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            js = np.nonzero(valid[i1] & valid[i2])[0]
            if js.size < 2:
                continue
            d = (base[i1, js] - base[i2, js]) % z
            # pair (j1, j2): a cycle iff d[j1] == d[j2]
            _, cnts = np.unique(d, return_counts=True)
            four += int((cnts * (cnts - 1) // 2).sum()) * z
    six = 0
    for a in range(mb):
        for b in range(a + 1, mb):
            for c in range(b + 1, mb):
                # walk a→b→c→a through columns j1, j2, j3 (distinct):
                # (s[a,j1] − s[b,j1]) + (s[b,j2] − s[c,j2])
                # + (s[c,j3] − s[a,j3]) ≡ 0 (mod z)
                jab = np.nonzero(valid[a] & valid[b])[0]
                jbc = np.nonzero(valid[b] & valid[c])[0]
                jca = np.nonzero(valid[c] & valid[a])[0]
                if not (jab.size and jbc.size and jca.size):
                    continue
                d1 = (base[a, jab] - base[b, jab]) % z
                d2 = (base[b, jbc] - base[c, jbc]) % z
                d3 = (base[c, jca] - base[a, jca]) % z
                tot = (
                    d1[:, None, None] + d2[None, :, None]
                    + d3[None, None, :]
                ) % z == 0
                distinct = (
                    (jab[:, None, None] != jbc[None, :, None])
                    & (jbc[None, :, None] != jca[None, None, :])
                    & (jab[:, None, None] != jca[None, None, :])
                )
                six += int((tot & distinct).sum()) * z
    return {"cycles_4": four, "cycles_6": six,
            "girth_lower_bound": 8 if four == 0 and six == 0 else (
                6 if four == 0 else 4)}


def code_report(code: LdpcCode, de: bool = False,
                de_kw: dict | None = None, device="cuda") -> dict:
    """Full analysis report (the ``cli code-info`` payload). ``de=True``
    adds the min-sum and sum-product DE thresholds of a QC code's base
    (:func:`.de.de_threshold`, 50 iterations and 4096 samples unless
    ``de_kw`` says otherwise), computed on ``device``."""
    rep: dict = {
        "name": code.name,
        "n": code.n,
        "k": code.k,
        "rate": code.rate,
        **degree_profile(code.H),
    }
    if code.qc is not None:
        base = np.asarray(code.qc.base)
        rep["qc"] = {
            "z": code.qc.z,
            "base_shape": list(base.shape),
            **qc_cycle_counts(base, code.qc.z),
        }
    if de and code.qc is not None:
        from ldpc_sims_tpu_torch.codes.de import de_threshold

        kw = dict(iterations=50, samples=1 << 12, device=device)
        kw.update(de_kw or {})
        base = np.asarray(code.qc.base)
        rep["de_threshold_db"] = {
            m: round(de_threshold(base, method=m, **kw), 3)
            for m in ("min-sum", "sum-product")
        }
    return rep
