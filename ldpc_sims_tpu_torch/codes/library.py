"""LDPC code library (the port's own copy of ``ldpc_sims_tpu.codes.library``).

The arrays are host NumPy and identical to the JAX package's for every
registered name; device tensors derived from them are cached per code
(:meth:`LdpcCode.cached`). Provides the reference's (64,32) PEG code as the BER-parity anchor plus the
larger standard codes the framework targets: regular PEG constructions
(e.g. (128,64)) and IEEE 802.11n QC-LDPC codes ((648,324), (1296,648),
(1944,972)) — none of which exist in the reference and are required by the
benchmark configs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ldpc_sims_tpu_torch.codes import gf2
from ldpc_sims_tpu_torch.codes.tanner import TannerGraph

__all__ = [
    "LdpcCode",
    "QcStructure",
    "reference_6432",
    "make_regular_ldpc",
    "get_code",
]


@dataclasses.dataclass(frozen=True)
class QcStructure:
    """Quasi-cyclic structure: H is an (mb × nb) grid of z×z circulants.

    ``base[i][j]`` is the cyclic shift of block (i, j), −1 for a zero
    block. The Tanner-graph message permutation within a circulant block
    is a cyclic shift of the z axis: the decode kernels index it directly
    and the plain version rolls it (see ops/bp_roll.py).
    """

    z: int
    base: tuple[tuple[int, ...], ...]

    @property
    def mb(self) -> int:
        return len(self.base)

    @property
    def nb(self) -> int:
        return len(self.base[0])


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """An LDPC code: parity-check matrix + derived systematic encoder.

    ``H`` is (m, n) uint8. Encoding: info word u (length k) maps to the
    codeword c with ``c[perm] = G @ u (mod 2)`` where ``G = [[I_k],[A]]``;
    for all library codes ``perm[:k] == arange(k)`` so info bits occupy
    positions 0..k-1, matching the reference convention of measuring coded
    BER on ``codeword[:, 0:k]`` (``evaluate_snr.py:128-133``).

    ``qc`` carries the quasi-cyclic structure when the code has one
    (802.11n family) — it selects the QC decode kernels.
    """

    name: str
    H: np.ndarray
    qc: "QcStructure | None" = None

    def __post_init__(self):
        H = np.asarray(self.H, dtype=np.uint8) & 1
        object.__setattr__(self, "H", H)
        object.__setattr__(self, "_cache", {})

    def cached(self, key, build):
        """``build()`` once per ``key`` for this code (device tables such
        as the encoder's generator on a given device)."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    @property
    def n(self) -> int:
        return self.H.shape[1]

    @property
    def m(self) -> int:
        return self.H.shape[0]

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    @functools.cached_property
    def _gen(self) -> tuple[np.ndarray, np.ndarray]:
        return gf2.generator_from_H(self.H)

    @property
    def G(self) -> np.ndarray:
        """(n, k) systematic generator in permuted coordinates."""
        return self._gen[0]

    @property
    def perm(self) -> np.ndarray:
        """Permuted position i holds original codeword position perm[i]."""
        return self._gen[1]

    @functools.cached_property
    def inv_perm(self) -> np.ndarray:
        """c_original = c_permuted[inv_perm]."""
        return np.argsort(self.perm)

    @functools.cached_property
    def graph(self) -> TannerGraph:
        return TannerGraph.from_H(self.H)

    @property
    def n_edges(self) -> int:
        return self.graph.n_edges

    def encode_np(self, u: np.ndarray) -> np.ndarray:
        """Host-side reference encoder (for tests). u: (..., k) bits."""
        u = np.asarray(u, dtype=np.uint8)
        cp = (u.astype(np.int64) @ self.G.T.astype(np.int64)) % 2
        return cp[..., self.inv_perm].astype(np.uint8)

    def __repr__(self) -> str:  # keep huge arrays out of reprs
        return (
            f"LdpcCode(name={self.name!r}, n={self.n}, k={self.k}, "
            f"edges={self.n_edges})"
        )


# The second neighbor of check r in the reference code: checks r connect to
# variables (r // 2, _REF_SECOND[r], 32 + r). This is the exact adjacency of
# the PEG-generated (64,32) H hardcoded at ``bp/parity.py:7-40`` (variable
# degrees 2 then 1, check degree 3, 96 edges), stored structurally instead
# of as a 32x64 literal. Verified identical to the reference matrix.
_REF_SECOND = (
    16, 17, 16, 18, 17, 19, 18, 20, 19, 21, 20, 22, 21, 23, 22, 24,
    23, 25, 24, 26, 25, 27, 26, 28, 27, 29, 28, 30, 29, 31, 30, 31,
)


def reference_6432() -> LdpcCode:
    """The reference's (64,32) rate-1/2 PEG code (``bp/parity.py:7-47``)."""
    H = np.zeros((32, 64), dtype=np.uint8)
    for r in range(32):
        H[r, r // 2] = 1
        H[r, _REF_SECOND[r]] = 1
        H[r, 32 + r] = 1
    return LdpcCode(name="ref6432", H=H)


def make_regular_ldpc(
    n: int, m: int, col_deg: int = 3, seed: int = 0, backend: str = "python"
) -> LdpcCode:
    """(n, n-m) regular-column-degree LDPC via progressive edge growth.

    A deterministic PEG construction (Hu, Eleftheriou, Arnold 2005): for
    each variable in turn, each new edge goes to the check node farthest
    from the variable in the current graph (maximal girth locally), ties
    broken by lowest current check degree then lowest index. Guarantees no
    4-cycles while the graph is sparse enough. The reference ships no code
    constructor at all (its one matrix came from an external web tool,
    ``bp/parity.py:1``); this fills the (128,64)-and-friends configs.

    ``backend='native'`` uses the C++ builder
    (:mod:`ldpc_sims_tpu_torch.native`, a copy of the JAX package's, built
    with g++ on first use): much faster for large n, but a *different*
    (equally valid) graph for the same seed, since its PRNG differs; the
    registry codes stay on the Python backend.
    """
    if backend == "native":
        from ldpc_sims_tpu_torch.native import peg_construct_native

        H = peg_construct_native(n, m, col_deg, seed)
        if gf2.rank(H) != m:
            raise ValueError("PEG produced rank-deficient H; change seed")
        return LdpcCode(name=f"peg{n}_{n - m}", H=H)
    rng = np.random.default_rng(seed)
    adj_v: list[list[int]] = [[] for _ in range(n)]  # var -> checks
    adj_c: list[list[int]] = [[] for _ in range(m)]  # check -> vars
    c_deg = np.zeros(m, dtype=np.int64)

    order = rng.permutation(n)  # randomized variable order, seeded
    for v in order:
        for _ in range(col_deg):
            # BFS from v over the current graph to find check distances
            dist = np.full(m, np.iinfo(np.int32).max, dtype=np.int64)
            seen_v = np.zeros(n, dtype=bool)
            seen_v[v] = True
            frontier = list(adj_v[v])
            d = 0
            for c in frontier:
                dist[c] = 0
            while frontier:
                nxt: list[int] = []
                for c in frontier:
                    for v2 in adj_c[c]:
                        if not seen_v[v2]:
                            seen_v[v2] = True
                            for c2 in adj_v[v2]:
                                if dist[c2] > d + 1:
                                    dist[c2] = d + 1
                                    nxt.append(c2)
                frontier = nxt
                d += 1
            # candidates: unreached checks if any, else farthest ones
            unreached = dist == np.iinfo(np.int32).max
            cand = np.nonzero(unreached)[0]
            if cand.size == 0:
                far = dist.max()
                cand = np.nonzero(dist == far)[0]
            # exclude checks already joined to v (no parallel edges)
            cand = np.setdiff1d(cand, np.array(adj_v[v], dtype=np.int64))
            if cand.size == 0:
                raise ValueError("PEG failed: no eligible check")
            best = cand[np.argsort(c_deg[cand], kind="stable")[0]]
            adj_v[v].append(int(best))
            adj_c[best].append(int(v))
            c_deg[best] += 1

    H = np.zeros((m, n), dtype=np.uint8)
    for v in range(n):
        H[adj_v[v], v] = 1
    # drop GF(2)-dependent rows if any (keeps encoder derivable)
    if gf2.rank(H) != m:
        raise ValueError("PEG produced rank-deficient H; change seed")
    return LdpcCode(name=f"peg{n}_{n - m}", H=H)


def list_codes() -> list[str]:
    """Registered code names (see :func:`get_code`)."""
    return sorted(_registry())


def get_code(name: str) -> LdpcCode:
    """Named code registry used by configs and the CLI."""
    registry = _registry()
    if name not in registry:
        raise KeyError(f"unknown code {name!r}; have {sorted(registry)}")
    return registry[name]()


def _registry() -> dict:
    from ldpc_sims_tpu_torch.codes import qc_construct, wifi

    def qc(z, mb, nm):
        # girth-aware QC construction, 802.11n family geometry (see
        # codes/qc_construct.py provenance note: these are OUR
        # deterministic constructions, not the Annex R tables)
        return lambda: qc_construct.make_qc_code(z, mb, 24, seed=7,
                                                 name=nm)

    registry = {
        "ref6432": reference_6432,
        "peg128_64": lambda: make_regular_ldpc(128, 64, 3, seed=1),
        "peg256_128": lambda: make_regular_ldpc(256, 128, 3, seed=1),
        "wifi648": lambda: wifi.wifi_80211n(648, "1/2"),
        "wifi1296": lambda: wifi.wifi_80211n(1296, "1/2"),
        "wifi1944": lambda: wifi.wifi_80211n(1944, "1/2"),
        # higher rates on the QC fast path (rate = (24−mb)/24)
        "qc648_r23": qc(27, 8, "qc648_r23"),
        "qc648_r34": qc(27, 6, "qc648_r34"),
        "qc648_r56": qc(27, 4, "qc648_r56"),
        "qc1944_r23": qc(81, 8, "qc1944_r23"),
        "qc1944_r34": qc(81, 6, "qc1944_r34"),
        "qc1944_r56": qc(81, 4, "qc1944_r56"),
        # 5G-class scale envelope (VERDICT r4 #6): n ≈ 8.4k at z=256
        # (rate 17/33 ≈ 0.515) and n = 12.3k at z=512 — the largest
        # codes the VMEM-resident kernel carries (f32 at n=8448;
        # bf16/int8 message storage at n=12288, where halving/quartering
        # message VMEM is what makes the plan fit — the realized win of
        # the sub-f32 storage modes). Same girth-aware construction and
        # provenance caveat as the other qc* codes.
        "qc8448_r12": lambda: qc_construct.make_qc_code(
            256, 16, 33, seed=7, name="qc8448_r12"
        ),
        "qc12288_r12": lambda: qc_construct.make_qc_code(
            512, 12, 24, seed=7, name="qc12288_r12"
        ),
    }
    return registry
