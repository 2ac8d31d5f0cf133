"""The GF(2) encode kernel's host tables (CPU).

``encode_plan``'s packed table and position map, run through a NumPy
emulation of the kernel's arithmetic (ballot packing, the tensor-core
AND-and-popcount sums over 256-bit chunks, the parity, placement, position
chunks), reproduce the plain ``encode`` bit for bit on every library code;
the layout fits the kernel's shared memory. The kernel itself runs in
``tests/test_torch_gpu.py`` on the card.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.codes.library import list_codes
from ldpc_sims_tpu_torch.ops.encode import (
    CHUNK_ORDER,
    SMEM_LIMIT,
    TILE,
    encode,
    encode_plan,
)

# the module (the package's ``ops.encode`` is the function)
encode_mod = importlib.import_module("ldpc_sims_tpu_torch.ops.encode")
CODES = list_codes()


@functools.cache
def code_of(name):
    return get_code(name)


def popcount32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def pack_like_the_kernel(plan, u: np.ndarray) -> np.ndarray:
    """The ballots: bit j of word w from byte 32·w + j (bit = byte & 1,
    zero past k), each chunk's words v0..v7 stored as v0 v4 v1 v5 v2 v6 v3
    v7, the row padded to the stride."""
    B = u.shape[0]
    bits = np.zeros((B, plan.kchunks * 256), np.uint8)
    bits[:, :plan.k] = u & 1
    w = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    w = w.reshape(B, plan.kchunks, 8)
    out = np.zeros((B, plan.stride), np.uint32)
    for s, src in enumerate((0, 4, 1, 5, 2, 6, 3, 7)):
        out[:, s:plan.kchunks * 8:8] = w[:, :, src]
    return out


def emulate(plan, u: np.ndarray) -> np.ndarray:
    """csrc/encode.cu's arithmetic on (batch, k) int8 info bits, every
    codeword at once: per position chunk, the copies read from the packed
    words (word w of a chunk at slot 2 (w % 4) + w / 4), then per block of
    8 parity rows (the last row clamped to the table) each 256-bit chunk's
    mma, Σ popc(u & P) over the slots, summed over the chunks; the parity
    is the sum & 1, stored for the block's rows below the chunk's end; the
    stage's first ``plen`` bytes are the chunk's output."""
    B = u.shape[0]
    packed = pack_like_the_kernel(plan, u)
    rows = len(plan.par_pos)
    words = plan.kchunks * 8
    out = np.zeros((B, plan.n), np.int8)
    for pc in range(plan.chunks):
        p0 = pc * plan.chunk
        stage = np.full((B, plan.sstride), 0xAA, np.uint8)  # stale bytes
        q = slice(plan.copy_lo[pc], plan.copy_lo[pc + 1])
        src = plan.copy_src[q]
        w = src >> 5
        slot = (w & ~7) | ((w & 3) << 1) | ((w >> 2) & 1)
        stage[:, plan.copy_pos[q] - p0] = (
            packed[:, slot] >> (src & 31).astype(np.uint32)) & 1
        rlo, rhi = plan.row_lo[pc], plan.row_lo[pc + 1]
        for r0 in range(rlo, rhi, 8):
            rb = np.minimum(np.arange(r0, r0 + 8), rows - 1)
            both = packed[:, None, :words] & plan.table[None, rb, :words]
            c = popcount32(both).astype(np.int64).sum(axis=2)  # (B, 8)
            keep = np.arange(r0, r0 + 8) < rhi
            pos = plan.par_pos[np.arange(r0, r0 + 8)[keep]] - p0
            stage[:, pos] = (c[:, keep] & 1).astype(np.uint8)
        plen = min(plan.chunk, plan.n - p0)
        out[:, p0:p0 + plen] = stage[:, :plen].view(np.int8)
    return out


def info_bits(code, batch, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.int8)
    # one row of arbitrary bytes: every encoder takes bit = byte & 1
    u[-1] = rng.integers(-128, 128, code.k)
    return u


def check_layout(plan):
    n, k = plan.n, plan.k
    # the positions split into copies and parity rows, each sorted
    both = np.concatenate([plan.copy_pos, plan.par_pos])
    np.testing.assert_array_equal(np.sort(both), np.arange(n))
    assert np.all(np.diff(plan.copy_pos) > 0)
    assert np.all(np.diff(plan.par_pos) > 0)
    assert np.all((0 <= plan.copy_src) & (plan.copy_src < k))
    # the table: 256-bit chunks covering k bits, each in CHUNK_ORDER, the
    # row stride 8 or 24 words mod 32, nothing set past k or in the padding
    words = plan.kchunks * 8
    assert plan.table.dtype == np.uint32 and plan.table.flags.c_contiguous
    assert plan.kchunks * 256 >= k > (plan.kchunks - 1) * 256
    assert plan.stride in (words, words + 8) and plan.stride % 32 in (8, 24)
    assert not plan.table[:, words:].any()
    order = np.argsort(CHUNK_ORDER)
    logical = plan.table[:, :words].reshape(-1, plan.kchunks, 8)[:, :, order]
    tail = np.unpackbits(np.ascontiguousarray(logical).reshape(
        len(logical), -1).view(np.uint8), axis=1, bitorder="little")[:, k:]
    assert not tail.any()
    # the chunks: each one's rows and copies, 4-B aligned write-out
    assert plan.chunks == -(-n // plan.chunk)
    assert plan.chunks == 1 or plan.chunk % 16 == 0
    assert plan.sstride % 4 == 0 and (plan.sstride // 4) % 2 == 1
    assert plan.sstride >= plan.chunk
    for lo, pos in ((plan.row_lo, plan.par_pos),
                    (plan.copy_lo, plan.copy_pos)):
        assert lo[0] == 0 and lo[-1] == len(pos)
        for i in range(plan.chunks):
            p = pos[lo[i]:lo[i + 1]]
            assert np.all((i * plan.chunk <= p) & (p < (i + 1) * plan.chunk))
    want = ((plan.table.nbytes if plan.smem_table else 0)
            + TILE * plan.stride * 4 + TILE * plan.sstride)
    assert plan.smem_bytes == want <= SMEM_LIMIT


@pytest.mark.parametrize("name", CODES)
def test_emulated_kernel_reproduces_encode(name):
    code = code_of(name)
    plan = encode_plan(code)
    check_layout(plan)
    u = info_bits(code, 37)
    want = encode(torch.from_numpy(u), code).numpy()
    np.testing.assert_array_equal(want, code.encode_np(u & 1))
    np.testing.assert_array_equal(emulate(plan, u), want)


@pytest.mark.parametrize("name", ["wifi1944", "peg256_128", "qc1944_r23"])
def test_emulated_kernel_in_chunks(name, monkeypatch):
    """Less shared memory: the table through L2 and the positions in
    chunks of 16 B multiples, the path of the 5G-class codes."""
    code = code_of(name)
    packed = TILE * (encode_plan(code).stride * 4)
    monkeypatch.setattr(encode_mod, "SMEM_LIMIT", packed + TILE * 200)
    plan = encode_plan(code)
    assert not plan.smem_table and plan.chunks > 1
    check_layout(plan)
    u = info_bits(code, 9, seed=1)
    np.testing.assert_array_equal(emulate(plan, u),
                                  encode(torch.from_numpy(u), code).numpy())


def test_plans_of_the_main_codes():
    """wifi1944: the table (972 rows of four 256-bit chunks, 40 words with
    the padding) in shared memory with the whole codeword staged;
    peg256_128: info bits off [0, k); the 5G-class codes: the table
    through L2, the staging in chunks."""
    plan = encode_plan(code_of("wifi1944"))
    assert plan.table.shape == (972, 40) and plan.smem_table
    assert plan.kchunks == 4 and plan.chunks == 1 and plan.sstride == 1948
    assert plan.smem_bytes == 972 * 160 + 32 * 160 + 32 * 1948
    np.testing.assert_array_equal(plan.copy_pos, np.arange(972))
    np.testing.assert_array_equal(plan.copy_src, np.arange(972))
    peg = encode_plan(code_of("peg256_128"))
    assert not np.array_equal(peg.copy_pos, np.arange(128))
    for name in ("qc8448_r12", "qc12288_r12"):
        plan = encode_plan(code_of(name))
        assert not plan.smem_table and plan.chunks == 2, name


def test_kernel_refuses_cpu_tensors():
    code = code_of("wifi648")
    with pytest.raises(ValueError, match="CUDA"):
        encode_mod.encode_cuda(torch.zeros((4, code.k), dtype=torch.int8),
                               code)
