"""Systematic LDPC encoding on the device (the port of ``ops/encode.py``).

:func:`encode` launches the GF(2) encode kernel (``kernels/csrc/encode.cu``,
built into the kernels' library by :func:`..kernels.minsum_qc.build`) for a
CUDA tensor, and runs the plain version, :func:`encode_plain`, for a CPU
tensor; nothing else selects the plain version. The kernel reads the tables
of :func:`encode_plan`, made on the host once per code. ``ENCODE_LAUNCHES``
counts its launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode

__all__ = [
    "ENCODE_LAUNCHES",
    "EncodePlan",
    "encode",
    "encode_cuda",
    "encode_plain",
    "encode_plan",
]

# launches of the encode kernel since the process started
ENCODE_LAUNCHES = 0
# dynamic shared memory one H100 CTA may use
SMEM_LIMIT = 232_448
# codewords a CTA tile (csrc/encode.cu: kTile)
TILE = 32
# each 256-bit chunk's eight packed words in the order the kernel's mma
# fragments read them: slot 2t holds word t, slot 2t + 1 word t + 4
CHUNK_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)
# the table goes into shared memory where it leaves room for a staging of
# at least this many output positions
_MIN_SMEM_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """The encode kernel's tables and layout for one code (the fields of
    csrc/encode.cu's ``EncodeArgs``).

    Row p of the original-order generator ``G[inv_perm]`` (n × k) gives
    output position p. A unit row copies one info bit: ``copy_src[q]`` to
    ``copy_pos[q]``. Any other row is a parity row r at ``par_pos[r]``,
    packed into ``table[r]``: the k bits in ``kchunks`` chunks of 256, each
    chunk eight little-endian words (bit b of word w is info bit 32·w + b)
    in ``CHUNK_ORDER``, the row padded to ``stride`` words. Both are sorted
    by position. The positions are staged in chunks of ``chunk``: chunk i
    holds the parity rows ``row_lo[i]:row_lo[i + 1]`` and the copies
    ``copy_lo[i]:copy_lo[i + 1]``.
    """

    n: int
    k: int
    table: np.ndarray  # (rows, stride) uint32
    par_pos: np.ndarray  # (rows,) int32
    copy_src: np.ndarray  # (copies,) int32
    copy_pos: np.ndarray  # (copies,) int32
    row_lo: np.ndarray  # (chunks + 1,) int32
    copy_lo: np.ndarray  # (chunks + 1,) int32
    kchunks: int  # 256-bit chunks of the info bits
    stride: int  # words a table row and a packed codeword
    chunk: int  # output positions a chunk
    sstride: int  # bytes a staged codeword chunk
    smem_table: bool  # the table is copied into shared memory
    smem_bytes: int  # dynamic shared memory a CTA takes

    @property
    def chunks(self) -> int:
        return len(self.row_lo) - 1


def _stage_stride(chunk: int) -> int:
    """Bytes a staged codeword chunk: a multiple of 4 whose word count is
    odd, so 32 lanes' rows fall in 32 different banks."""
    s = -(-chunk // 4) * 4
    return s if (s // 4) % 2 else s + 4


def encode_plan(code: LdpcCode) -> EncodePlan:
    """The kernel's tables and layout for ``code`` (host NumPy).

    A row of the table or of the packed codewords takes ``kchunks`` × 8
    words, and 8 more where that is a multiple of 16, so that a half-warp's
    8-B fragment loads of four rows fall on 32 different banks. The table
    sits in shared memory when it leaves room for the staging of
    ``_MIN_SMEM_CHUNK`` positions (or all n), else the kernel reads it
    through L2; the staging takes all n positions where they fit, else the
    most that do, a multiple of 16.
    """
    go = code.G[code.inv_perm]  # (n, k): output position p = go[p]·u
    n, k = go.shape
    unit = go.sum(axis=1) == 1
    copy_pos = np.flatnonzero(unit)
    copy_src = go[copy_pos].argmax(axis=1)
    par_pos = np.flatnonzero(~unit)
    kchunks = -(-k // 256)
    words = kchunks * 8
    stride = words + (8 if words % 16 == 0 else 0)
    bits = np.zeros((len(par_pos), words * 32), np.uint8)
    bits[:, :k] = go[par_pos]
    packed = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    table = np.zeros((len(par_pos), stride), np.uint32)
    table[:, :words] = packed.reshape(-1, kchunks, 8)[
        :, :, list(CHUNK_ORDER)].reshape(-1, words)
    per_row = TILE * stride * 4  # the packed codewords

    def smem(chunk: int, with_table: bool) -> int:
        return (table.nbytes if with_table else 0) + per_row + (
            TILE * _stage_stride(chunk))

    smem_table = smem(min(n, _MIN_SMEM_CHUNK), True) <= SMEM_LIMIT
    chunk = n
    if smem(n, smem_table) > SMEM_LIMIT:
        chunk = (SMEM_LIMIT - smem(0, smem_table)) // TILE // 16 * 16
        while chunk > 0 and smem(chunk, smem_table) > SMEM_LIMIT:
            chunk -= 16
        if chunk <= 0:
            raise ValueError(f"{code.name}: the encode's packed codewords "
                             f"leave no room in {SMEM_LIMIT} B of shared "
                             f"memory")
    bounds = np.arange(-(-n // chunk) + 1) * chunk

    def i32(x) -> np.ndarray:
        return np.ascontiguousarray(x, dtype=np.int32)

    return EncodePlan(
        n=n, k=k, table=table, par_pos=i32(par_pos), copy_src=i32(copy_src),
        copy_pos=i32(copy_pos), row_lo=i32(np.searchsorted(par_pos, bounds)),
        copy_lo=i32(np.searchsorted(copy_pos, bounds)), kchunks=kchunks,
        stride=stride, chunk=chunk, sstride=_stage_stride(chunk),
        smem_table=smem_table,
        smem_bytes=smem(chunk, smem_table),
    )


def _device_plan(code: LdpcCode, dev: torch.device):
    """(plan, its tables on ``dev``, their device pointers)."""
    plan = encode_plan(code)
    tabs = [torch.from_numpy(a.view(np.int32)).to(dev) for a in (
        plan.table, plan.par_pos, plan.copy_src, plan.copy_pos,
        plan.row_lo, plan.copy_lo)]
    return plan, tabs, [t.data_ptr() for t in tabs]


def encode(u: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """(batch, k) info bits → (batch, n) int8 codewords, ``c[perm] = G·u
    mod 2`` with G the systematic generator: the kernel for a CUDA tensor
    (:func:`encode_cuda`), the plain version for a CPU one."""
    if u.device.type == "cpu":
        return encode_plain(u, code)
    return encode_cuda(u, code)


def encode_cuda(u: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """One launch of the encode kernel: (batch, k) contiguous int8 info
    bits on a CUDA device (bit = byte & 1) → (batch, n) int8 codewords.
    Raises on any other input."""
    global ENCODE_LAUNCHES
    if u.device.type != "cuda":
        raise ValueError(f"the encode kernel takes a CUDA tensor, not one "
                         f"on {u.device}")
    if u.dtype != torch.int8:
        raise ValueError(f"info bits must be int8, not {u.dtype}")
    if u.dim() != 2 or u.shape[1] != code.k:
        raise ValueError(f"info bits must be (batch, {code.k}), not "
                         f"{tuple(u.shape)}")
    if u.shape[0] < 1:
        raise ValueError("empty batch")
    if not u.is_contiguous():
        raise ValueError("info bits must be contiguous")
    from ldpc_sims_tpu_torch.kernels.minsum_qc import _library

    plan, _, ptrs = code.cached(("encode_plan", str(u.device)),
                                lambda: _device_plan(code, u.device))
    out = torch.empty((u.shape[0], code.n), dtype=torch.int8, device=u.device)
    lib = _library()
    err = lib.ldpc_encode(
        u.data_ptr(), out.data_ptr(), *ptrs, u.shape[0], plan.n, plan.k,
        plan.kchunks, plan.stride, plan.chunk, plan.sstride, plan.chunks,
        len(plan.par_pos), int(plan.smem_table), plan.smem_bytes,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode_gf2 launch failed: "
                           f"{lib.bp_qc_error_string(err).decode()}")
    ENCODE_LAUNCHES += 1
    return out


def encode_plain(u: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """The plain version, on any device: a float32 product of the 0/1
    matrices, then ``& 1``. Exact, because every sum is an integer
    ≤ k < 2^24; TF32 is switched off for the product all the same."""
    dev = u.device
    Gt = code.cached(
        ("encode_Gt", str(dev)),
        lambda: torch.from_numpy(code.G.T.copy()).to(dev, torch.float32),
    )
    inv_perm = code.cached(
        ("encode_inv_perm", str(dev)),
        lambda: torch.from_numpy(code.inv_perm).to(dev),
    )
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cp = torch.matmul(u.to(torch.float32), Gt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cp = (cp.to(torch.int32) & 1).to(torch.int8)
    return cp.index_select(1, inv_perm)
