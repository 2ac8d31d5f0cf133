"""The decode kernels' module on the CPU: its plain version against the
Pallas kernel itself (interpret mode), its plan table, and the kernels'
loops transliterated to NumPy over that plan.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what
they compute is checked here by running the loops of
csrc/minsum_qc.cu line for line in NumPy on the plan table the wrapper
hands them, fixed and early-stop forms, min-sum and sum-product, with and
without message quantization, against the plain version, and the
compressed min-sum flooding loop (state, old messages, check pass,
posterior rebuild) at each storage type with per-edge weights and early
stop, against the plain version and the Pallas kernel. Min-sum, with
or without quantization, agrees exactly. Sum-product agrees within 1e-5
(absolute and relative): NumPy's float32 exp/expm1/log1p/log round
differently from PyTorch's on the CPU, and PyTorch's own CPU log1p
differs in the last bit between vector lanes and scalar tails; on the
card both sides call the same libdevice functions (tests/test_torch_gpu.py
asks for equality of bits there).
"""

import functools
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
from ldpc_sims_tpu_torch.codes import get_code, list_codes
from ldpc_sims_tpu_torch.convert import load_trained_schedule
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import init_neural_bp_weights
from ldpc_sims_tpu_torch.ops.bp_roll import (
    decode_roll,
    pack_edge_weights,
    qc_plan,
)
from test_torch_group_serial import degree10_qc

SCHEDULES = os.path.join(os.path.dirname(__file__), "..", "docs",
                         "artifacts", "minsum_trained_schedules.json")
A8, B8 = load_trained_schedule(SCHEDULES, "wifi1944", 8)


def noisy_llrs(n, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3, (batch, n)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(iterations=20, schedule="flooding"),
    dict(iterations=8, schedule="layered", alpha=A8, beta=B8, clamp=20.0),
], ids=["flooding-20", "trained-layered-8-clamp20"])
def test_plain_version_matches_pallas_interpret(kw):
    """wifi648 against bp_qc_pallas itself, run as tests/test_kernels.py
    runs it on the CPU; the port follows its summation order exactly."""
    code = jax_get_code("wifi648")
    llr = noisy_llrs(code.n, 128)
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr), code.qc, interpret=True,
                                  output="posterior", **kw))
    ours = mq.bp_qc_cuda(torch.from_numpy(llr), get_code("wifi648").qc,
                         output="posterior", **kw).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    sure = np.abs(ref) > 1e-3
    np.testing.assert_array_equal((ours > 0)[sure], (ref > 0)[sure])


def unpack_plan(qc):
    plan = mq._plan_array(qc)
    P, mb, nb = len(qc_plan(qc)[0]), qc.mb, qc.nb
    cuts = np.cumsum([mb + 1, P, P, nb + 1])
    row_ptr, col, shift, col_ptr, col_planes = np.split(plan, cuts)
    return row_ptr, col, shift, col_ptr, col_planes


def emulate_kernel(llr, qc, iterations, alpha, beta, clamp, layered,
                   early_stop=False, check_every=1, method="min-sum",
                   msg_qbits=None, msg_qclip=20.0, compressed=False,
                   dtype=torch.float32, weights=None, word_bits=8):
    """The kernels' decode for a (B, n) LLR batch; returns the posterior
    in the log(Pr1/Pr0) convention and the (B,) iterations each codeword
    ran (``iterations`` for the fixed forms). Each codeword is one CTA:
    under early stop it votes on its syndrome at entry and after every
    ``check_every``-th iteration and leaves the loop when it holds.
    ``compressed``: the min-sum serial-C or flooding loop on the
    compressed check state (:func:`emulate_flooding_cs`), which also
    takes the storage ``dtype``, edge-flavor ``weights`` and the word's
    sign bits ``word_bits`` (8 for the _cs kernels, 24 for the _cw
    kernels' wide word)."""
    if compressed:
        return emulate_flooding_cs(llr, qc, iterations, alpha, beta, clamp,
                                   early_stop, check_every, msg_qbits,
                                   msg_qclip, dtype, weights, layered,
                                   word_bits)
    f32 = np.float32
    row_ptr, col, shift, col_ptr, col_planes = unpack_plan(qc)
    ab = mq._ab_table(alpha, beta, iterations)
    z, mb, nb = qc.z, qc.mb, qc.nb
    clamp = f32(np.inf if clamp is None else clamp)
    if msg_qbits is not None:
        qstep = f32(2.0 * msg_qclip / (2**msg_qbits - 1))
        qclip = f32(msg_qclip)

    def sp_lt(v):
        a = np.maximum(np.abs(v), f32(1e-12))
        return np.log(-np.expm1(-a)) - np.log1p(np.exp(-a))

    def sp_mag(s):
        return np.log1p(np.exp(s)) - np.log(-np.expm1(s))

    def check_update(msg, post, i, r, a, b):
        B = msg.shape[2]
        p0, p1 = row_ptr[i], row_ptr[i + 1]
        min1 = np.full(B, 1e30, f32)
        min2 = np.full(B, 1e30, f32)
        idx = np.full(B, -1)
        nneg = np.zeros(B, np.int64)
        lts, total = [], np.zeros(B, f32)
        for p in range(p0, p1):
            q = (r + shift[p]) % z
            v = post[col[p] * z + q] - msg[p, r]
            nneg += v < 0
            if method == "sum-product":
                lts.append(sp_lt(v))
                total = total + lts[-1]
                continue
            av = np.abs(v)
            lt1 = av < min1
            lt2 = ~lt1 & (av < min2)
            min2 = np.where(lt1, min1, np.where(lt2, av, min2))
            min1 = np.where(lt1, av, min1)
            idx = np.where(lt1, p, idx)
        for p in range(p0, p1):
            q = (r + shift[p]) % z
            vi = col[p] * z + q
            old = msg[p, r].copy()
            v = post[vi] - old
            exneg = (nneg - (v < 0)) & 1
            sgn = np.where(exneg == 1, f32(-1), f32(1))
            if method == "sum-product":
                s = np.minimum(total - lts[p - p0], f32(-1e-12))
                y = sgn * sp_mag(s)
            else:
                exmin = np.where(idx == p, min2, min1)
                y = (sgn * np.maximum(exmin - f32(b), f32(0))) * f32(a)
            y = np.minimum(np.maximum(y, -clamp), clamp).astype(f32)
            if msg_qbits is not None:
                y = np.rint(y / qstep) * qstep
                y = np.minimum(np.maximum(y, -qclip), qclip).astype(f32)
            msg[p, r] = y
            if layered:
                post[vi] = post[vi] + (y - old)

    def iterate(msg, post, lv, it):
        a, b = ab[it]
        if layered:
            for i in range(mb):
                for r in range(z):
                    check_update(msg, post, i, r, a, b)
        else:
            for c in range(mb * z):
                check_update(msg, post, c // z, c % z, a, b)
            for v in range(nb * z):
                j, q = divmod(v, z)
                acc = lv[v].copy()
                for e in range(col_ptr[j], col_ptr[j + 1]):
                    p = col_planes[e]
                    acc = acc + msg[p, (q - shift[p]) % z]
                post[v] = acc

    def unsat(post):
        """local_unsat summed over the CTA's threads."""
        count = np.zeros(post.shape[1], np.int64)
        for c in range(mb * z):
            i, r = divmod(c, z)
            parity = np.zeros(post.shape[1], np.int64)
            for p in range(row_ptr[i], row_ptr[i + 1]):
                parity ^= post[col[p] * z + (r + shift[p]) % z] < 0
            count += parity
        return count

    B = llr.shape[0]
    msg = np.zeros((len(col), z, B), f32)
    post = (-llr.T).astype(f32)  # (n, B)
    lv = post.copy()
    iters = np.full(B, iterations)
    if not early_stop:
        for it in range(iterations):
            iterate(msg, post, lv, it)
        return -post.T, iters

    out = np.zeros_like(post)
    idx = np.arange(B)
    K = check_every
    for r in range(-1, iterations // K):
        if r >= 0:
            for k in range(K):
                iterate(msg, post, lv, r * K + k)
        ok = unsat(post) == 0  # the CTAs whose vote passes leave the loop
        out[:, idx[ok]] = post[:, ok]
        iters[idx[ok]] = (r + 1) * K
        msg, post, lv, idx = msg[..., ~ok], post[:, ~ok], lv[:, ~ok], idx[~ok]
        if idx.size == 0:
            break
    out[:, idx] = post
    return -out.T, iters


def unsat_count(post, qc):
    """local_unsat summed over a CTA's threads, for (n, B) posteriors."""
    row_ptr, col, shift, _, _ = unpack_plan(qc)
    z, r = qc.z, np.arange(qc.z)
    count = np.zeros(post.shape[1], np.int64)
    for i in range(qc.mb):
        parity = np.zeros((z, post.shape[1]), np.int64)
        for p in range(row_ptr[i], row_ptr[i + 1]):
            parity ^= post[col[p] * z + (r + shift[p]) % z] < 0
        count += parity.sum(0)
    return count


def emulate_flooding_cs(llr, qc, iterations, alpha, beta, clamp,
                        early_stop=False, check_every=1, msg_qbits=None,
                        msg_qclip=20.0, dtype=torch.float32, weights=None,
                        layered=False, word_bits=8):
    """The compressed min-sum flooding kernels (csrc/minsum_qc.cu:
    flood_checks_cs, flood_rebuild_cs) in NumPy, vectorized over a block's
    z checks or variables and the batch. A check keeps T(min1), T(min2) as
    stored codes (f32 and bf16: the value; int8: the integer on the grid)
    and one word: its exclusive-sign bits (bits 0 to ``word_bits`` − 1)
    and the slot of its first minimum above them, packed as the kernels
    pack it (``word_bits`` 8: the _cs kernels' 16-bit word; 24: the _cw
    kernels' 32-bit wide word). Each iteration rebuilds a check's old
    messages from that state (the sign applied to the code: −0 survives in
    f32 and bf16, an int8 zero lifts to +0), forms each v2c through the
    message storage, writes the new state, then rebuilds every posterior
    as (wl·) LLR + Σ (w·) message in check-sorted order, rounded once to
    the posterior's storage, reading each entry's slot from the flooding
    plan's packed sign bit and index field (flood_add). ``layered``: the
    serial-C kernels instead (check_update_cs, rebuild_cs): block row by
    block row, each slot's v2c from the posterior, the posterior written
    as store(pv + (w·)(y − old)) with y the unrounded new message (int8:
    the stored one), and the weighted forms' posterior rebuilt with the
    next row of weights after each iteration."""
    f32 = np.float32
    row_ptr, col, shift, col_ptr, col_planes = unpack_plan(qc)
    sign_mask = (1 << word_bits) - 1
    idx_mask = (7 if word_bits == 8 else 31) << word_bits
    # FloodPlan's column entries: the slot's sign bit and its index field
    cz = flood_plan(qc, word_bits)[3][:, 2]
    ab = mq._ab_table(alpha, beta, iterations)
    z, mb, nb = qc.z, qc.mb, qc.nb
    r_all = np.arange(z)
    clamp = f32(np.inf if clamp is None else clamp)
    qstep = None if msg_qbits is None else f32(
        2.0 * msg_qclip / (2**msg_qbits - 1))
    # the int8 grid's step and reciprocal, as the wrapper passes them
    sstep = f32(2.0 * msg_qclip / 255.0)
    sinv = f32(1.0 / (2.0 * msg_qclip / 255.0))

    def bf16(v):
        return torch.from_numpy(np.ascontiguousarray(v, f32)).to(
            torch.bfloat16).float().numpy()

    def code_of(v):  # store<Msg>
        if dtype == torch.bfloat16:
            return bf16(v)
        if dtype == torch.int8:  # an integer code: a -0 is the code 0
            return np.clip(np.rint(v * sinv), f32(-127), f32(127)) + f32(0)
        return v.astype(f32)

    def lift(c):
        return c * sstep if dtype == torch.int8 else c

    def st_post(v):
        return bf16(v) if dtype == torch.bfloat16 else v.astype(f32)

    wm = wl = None
    if weights is not None:
        wt = pack_edge_weights(weights, qc, iterations)
        wm, wl = wt.msg.numpy(), wt.llr.numpy()
    # plane p: its block row and its slot there
    row_of = np.repeat(np.arange(mb), np.diff(row_ptr))
    slot_of = np.arange(len(col)) - row_ptr[row_of]

    def signed(m1, m2, word, e):
        """The stored messages of slot e from magnitude codes and words."""
        code = np.where(word >> word_bits == e, m2, m1)
        code = np.where((word >> e) & 1 == 1, -code, code)
        if dtype == torch.int8:
            code = code + f32(0)  # the negated zero code is the code 0
        return code

    def message(state, i, e):
        """(z, B) messages of slot e of block row i's checks."""
        m1, m2, word = (s[i] for s in state)
        return lift(signed(m1, m2, word, e)).astype(f32)

    def checks(state, post, it):
        a, b = ab[it]
        new = [s.copy() for s in state]
        for i in range(mb):
            shape = (z, post.shape[1])
            min1 = np.full(shape, 1e30, f32)
            min2 = np.full(shape, 1e30, f32)
            first = np.full(shape, -1)
            negs = np.zeros(shape, np.int64)
            pvs, olds = [], []
            for e, p in enumerate(range(row_ptr[i], row_ptr[i + 1])):
                m = old = message(state, i, e)
                if wm is not None:
                    m = wm[it, p][:, None] * m
                pv = post[col[p] * z + (r_all + shift[p]) % z]
                if layered:
                    v = (pv - m).astype(f32)
                else:
                    v = lift(code_of(pv - m)).astype(f32)
                pvs.append(pv)
                olds.append(old)
                negs |= (v < 0).astype(np.int64) << e
                av = np.abs(v)
                lt1 = av < min1
                lt2 = ~lt1 & (av < min2)
                min2 = np.where(lt1, min1, np.where(lt2, av, min2))
                min1 = np.where(lt1, av, min1)
                first = np.where(lt1, e, first)

            def t(m):
                y = np.maximum(m - f32(b), f32(0)) * f32(a)
                y = np.minimum(np.maximum(y, -clamp), clamp)
                if qstep is not None:
                    y = np.minimum(np.maximum(np.rint(y / qstep) * qstep,
                                              -f32(msg_qclip)),
                                   f32(msg_qclip))
                return y.astype(f32)

            parity = np.bitwise_count(negs.astype(np.uint64)) & 1
            signs = (negs ^ np.where(parity == 1, sign_mask, 0)) & sign_mask
            word = signs | (np.maximum(first, 0) << word_bits)
            t1, t2 = t(min1), t(min2)
            new[0][i], new[1][i] = code_of(t1), code_of(t2)
            new[2][i] = word
            if not layered:
                continue
            # serial-C: the slots' changes folded into the posterior at once
            for e, p in enumerate(range(row_ptr[i], row_ptr[i + 1])):
                if dtype == torch.int8:
                    y = lift(signed(new[0][i], new[1][i], word, e))
                else:
                    y = signed(t1, t2, word, e)
                d = (y - olds[e]).astype(f32)
                if wm is not None:
                    d = wm[it, p][:, None] * d
                post[col[p] * z + (r_all + shift[p]) % z] = st_post(
                    pvs[e] + d)
        return new

    def rebuild(state, lv, row):
        post = np.empty_like(lv)
        for j in range(nb):
            acc = lv[j * z:(j + 1) * z]
            if wl is not None:
                acc = wl[row, j][:, None] * acc
            for e in range(col_ptr[j], col_ptr[j + 1]):
                p = col_planes[e]
                r = (r_all - shift[p]) % z
                m1, m2, word = (s[row_of[p]][r] for s in state)
                # flood_add: the entry's index field and sign bit
                second = ((word ^ cz[e]) & idx_mask) == 0
                neg = (word & cz[e] & sign_mask) != 0
                code = np.where(second, m2, m1)
                code = np.where(neg, -code, code)
                if dtype == torch.int8:
                    code = code + f32(0)
                m = lift(code).astype(f32)
                acc = acc + (m if wm is None else wm[row, p][r][:, None] * m)
            post[j * z:(j + 1) * z] = st_post(acc)
        return post

    B = llr.shape[0]
    lv = st_post(-llr.T)  # (n, B), the LLR as the posterior holds it
    zero = np.zeros((mb, z, B), f32) + code_of(np.zeros(1, f32))
    state = [zero, zero.copy(), np.zeros((mb, z, B), np.int64)]
    post = lv.copy() if wm is None else rebuild(state, lv, 0)
    iters = np.full(B, iterations)
    out = np.zeros_like(post)
    idx = np.arange(B)
    K = check_every
    for r in range(-1, iterations // K):
        if r >= 0:
            for k in range(K):
                state = checks(state, post, r * K + k)
                if not layered or wm is not None:
                    post = rebuild(state, lv, r * K + k + 1)
        if not early_stop:
            continue
        ok = unsat_count(post, qc) == 0  # the CTAs that leave the loop
        out[:, idx[ok]] = post[:, ok]
        iters[idx[ok]] = (r + 1) * K
        state = [s[..., ~ok] for s in state]
        post, lv, idx = post[:, ~ok], lv[:, ~ok], idx[~ok]
        if idx.size == 0:
            break
    out[:, idx] = post
    return -out.T, iters


@pytest.mark.parametrize(
    "name", [n for n in list_codes() if get_code(n).qc is not None
             and get_code(n).n <= 1944]
)
def test_plan_table_rebuilds_H(name):
    """Check i·z+r meets variable j·z+((r+s) mod z) for every plane of
    the table, and the column lists are each block's planes by row."""
    code = get_code(name)
    qc = code.qc
    row_ptr, col, shift, col_ptr, col_planes = unpack_plan(qc)
    z = qc.z
    H = np.zeros_like(code.H)
    r = np.arange(z)
    for i in range(qc.mb):
        for p in range(row_ptr[i], row_ptr[i + 1]):
            H[i * z + r, col[p] * z + (r + shift[p]) % z] = 1
    np.testing.assert_array_equal(H, code.H)
    for j in range(qc.nb):
        ps = col_planes[col_ptr[j]:col_ptr[j + 1]]
        assert np.all(col[ps] == j)
        rows = [np.searchsorted(row_ptr, p, side="right") - 1 for p in ps]
        assert rows == sorted(rows)


def test_smem_bytes_wifi1944():
    # full messages with the plan (group-serial, G = 2, of both rules on a
    # code with a row of a degree no wide body has: qc1944_r34's base with
    # one circulant dropped, rows of degree 10-12): plan 7 + 3·66 + 25 =
    # 230 ints (232 padded), 66·81 message and 1944 posterior f32 and the
    # f32 scratch of 2·12 planes, each region on a 16-byte boundary (the
    # messages' 21,384 B take 21,392)
    d10 = degree10_qc()
    for rule in ("sum-product", "min-sum"):
        assert mq.smem_bytes(d10, 2, method=rule,
                             schedule="layered") == 4 * 232 + 21_392 + \
            4 * 1944 + 4 * 24 * 81
    # qc1944_r23 (rows of degree 8-9) at G = 2 on the _gw kernels: no plan
    # and the scratch of its largest group's 12 shared planes; sum-product
    # the 65·81 messages (21,060 B take 21,072), min-sum the wide word's
    # state (648 checks: two f32 magnitudes and a 4-byte word each)
    r23 = get_code("qc1944_r23").qc
    assert mq.smem_bytes(r23, 2, method="sum-product", schedule="layered") \
        == 21_072 + 4 * 1944 + 4 * 12 * 81
    assert mq.smem_bytes(r23, 2, method="min-sum", schedule="layered") == \
        648 * 8 + 648 * 4 + 4 * 1944 + 4 * 12 * 81
    # wifi1944 group-serial (the _gs kernels): no plan (the kernel's
    # parameter holds it) and the scratch of the largest group's shared
    # planes only, 8 at G = 2 and 22 at G = 4: sum-product's messages,
    # min-sum's compressed state
    qc = get_code("wifi1944").qc
    assert mq.smem_bytes(qc, 2, method="sum-product",
                         schedule="layered") == 27_872 + 4 * 1944 + \
        4 * 8 * 81
    assert mq.smem_bytes(qc, 4, method="min-sum", schedule="layered") == \
        972 * 8 + 1952 + 4 * 1944 + 4 * 22 * 81
    # sum-product with its slots in registers: the same messages and
    # posterior without the plan (the kernel's parameter holds it), and
    # flooding with the LLRs beside the posterior
    assert mq.smem_bytes(qc, method="sum-product",
                         schedule="layered") == 27_872 + 4 * 1944
    assert mq.smem_bytes(qc, method="sum-product") == 27_872 + 2 * 4 * 1944
    # min-sum flooding on the compressed state: 972 checks of two f32
    # magnitudes and a 2-byte word (1944 B take 1952), the posterior and
    # the LLRs, and no plan (the kernel's parameter holds it)
    assert mq.smem_bytes(qc) == 972 * 8 + 1952 + 2 * 4 * 1944


@pytest.mark.parametrize("kw", [
    dict(iterations=3, layered=False, alpha=1.0, beta=0.0, clamp=None),
    dict(iterations=3, layered=False, alpha=0.75, beta=0.1, clamp=2.0),
    dict(iterations=3, layered=True, alpha=A8[:3], beta=B8[:3],
         clamp=None),
    dict(iterations=3, layered=False, alpha=1.0, beta=0.0, clamp=None,
         msg_qbits=4),
    dict(iterations=3, layered=True, alpha=0.8, beta=0.0, clamp=6.0,
         msg_qbits=3, msg_qclip=5.0),
], ids=["flooding", "flooding-a-b-clamp", "layered-tabled", "flooding-msgq4",
        "layered-msgq3-clip5"])
def test_kernel_loops_match_plain_version(kw):
    qc = get_code("wifi648").qc
    llr = noisy_llrs(648, 4, seed=3)
    ours, _ = emulate_kernel(llr, qc, **kw)
    layered = kw.pop("layered")
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior",
                      schedule="layered" if layered else "flooding",
                      **kw).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("layered, qbits", [(False, None), (True, None),
                                            (True, 5)],
                         ids=["flooding", "layered", "layered-msgq5"])
def test_sumproduct_kernel_loops_match_plain_version(layered, qbits):
    """The sum-product update (the row's lt values summed left to right,
    then each exclusive sum) within 1e-5, hard bits equal. A codeword
    saturated at |LLR| = 60 with random signs stays finite on both sides;
    its values are not compared: there Σlt − lt cancels to a few ulps of
    one large lt, so the last-bit differences of the two libraries' lt
    move a message by up to its bound of 28.3."""
    qc = get_code("wifi648").qc
    rng = np.random.default_rng(4)
    llr = rng.normal(0, 1.5, (4, 648)).astype(np.float32)
    llr[0] = np.where(llr[0] > 0, 60.0, -60.0)
    kw = dict(iterations=2, alpha=1.0, beta=0.0, clamp=None,
              method="sum-product", msg_qbits=qbits)
    ours, _ = emulate_kernel(llr, qc, layered=layered, **kw)
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior",
                      schedule="layered" if layered else "flooding",
                      **kw).numpy()
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(ours[1:], ref[1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[1:] > 0, ref[1:] > 0)


def bpsk_llrs(snrdb, seed):
    """One BPSK all-zero codeword of wifi648 over AWGN: log(Pr1/Pr0)."""
    rng = np.random.default_rng(seed)
    sigma = 10 ** (-snrdb / 20.0)
    r = 1.0 + sigma * rng.normal(0, 1, 648)
    return (-2.0 * r / (sigma * sigma)).astype(np.float32)


@pytest.mark.parametrize("layered, K, extra", [
    (False, 1, {}), (True, 1, {}), (True, 2, {}),
    (False, 1, dict(msg_qbits=4)),
], ids=["flooding-K1", "layered-K1", "layered-K2", "flooding-K1-msgq4"])
def test_early_stop_kernel_loop_matches_plain_version(layered, K, extra):
    """The ES kernels' loop (entry vote, K iterations, vote, leave) in
    NumPy against the plain version: posteriors and counts exactly."""
    qc = get_code("wifi648").qc
    rng = np.random.default_rng(3)
    # one codeword per regime: passes at entry, converges, never converges
    llr = np.stack([bpsk_llrs(12.0, seed=4), bpsk_llrs(4.0, seed=5),
                    bpsk_llrs(2.5, seed=6),
                    rng.normal(0, 3, 648).astype(np.float32)])
    ours, iters = emulate_kernel(llr, qc, iterations=6, alpha=0.8,
                                 beta=0.05, clamp=None, layered=layered,
                                 early_stop=True, check_every=K, **extra)
    kw = dict(iterations=6, alpha=0.8, beta=0.05, early_stop=True,
              es_check_every=K, schedule="layered" if layered else "flooding",
              **extra)
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior", **kw)
    _, ref_iters = decode_roll(torch.from_numpy(llr), qc,
                               output="hard_iters", **kw)
    np.testing.assert_array_equal(ours, ref.numpy())
    np.testing.assert_array_equal(iters, ref_iters.numpy())
    assert iters[0] == 0 and iters[-1] == 6 and 0 < iters[1] < 6


def integer_llrs(batch, seed):
    """wifi648 LLRs in {-3, ..., 3}: tied minima, zero magnitudes, and an
    offset above the minimum are common."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, (batch, 648)).astype(np.float32)


FLOODING_CS_CASES = {
    "table-clamp": dict(iterations=3, alpha=(1.0, 0.75, 0.5),
                        beta=(0.0, 1.0, 2.5), clamp=2.0),
    "msgq3": dict(iterations=3, alpha=0.8, beta=(1.5, 0.0, 0.5),
                  clamp=None, msg_qbits=3),
    "early-stop-K1": dict(iterations=6, alpha=0.8, beta=0.05, clamp=None,
                          early_stop=True, check_every=1, msg_qclip=20.0),
    "early-stop-K2": dict(iterations=6, alpha=0.8, beta=0.05, clamp=None,
                          early_stop=True, check_every=2, msg_qclip=20.0),
    "weighted": dict(iterations=2, alpha=0.75, beta=(0.0, 1.0), clamp=3.0,
                     weighted=True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(FLOODING_CS_CASES))
def test_compressed_flooding_loop_matches_plain_version(case, dtype):
    """The compressed min-sum flooding loop (state → old messages → check
    pass → posterior rebuild) against the plain version at each storage
    type: the α/β table with a clamp and β above the minimum, 3-bit
    messages, early stop at K = 1 and 2, per-edge weights. Posteriors and
    iteration counts exactly equal. Integer LLRs give ties, zero
    magnitudes and zero messages of both signs; the early-stop cases add
    the three regimes of a channel (passes at entry, converges, never)."""
    code = get_code("wifi648")
    kw = {"msg_qclip": 4.0, **FLOODING_CS_CASES[case]}
    weighted = kw.pop("weighted", False)
    K = kw.pop("check_every", 1)
    llr = integer_llrs(5, seed=11)
    if kw.get("early_stop"):
        llr = np.concatenate([llr[:2], np.stack([
            bpsk_llrs(12.0, seed=4), bpsk_llrs(4.0, seed=5),
            bpsk_llrs(2.5, seed=6)])])
    w = None
    if weighted:
        rng = np.random.default_rng(12)
        w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
             for k, v in init_neural_bp_weights(code, 2).items()}
    ours, iters = emulate_kernel(llr, code.qc, layered=False,
                                 compressed=True, dtype=dtype, weights=w,
                                 check_every=K, **kw)
    ref_kw = dict(kw, schedule="flooding", dtype=dtype, weights=w,
                  es_check_every=K)
    x = torch.from_numpy(llr)
    ref = decode_roll(x, code.qc, output="posterior", **ref_kw).numpy()
    np.testing.assert_array_equal(ours, ref)
    if kw.get("early_stop"):
        _, ref_iters = decode_roll(x, code.qc, output="hard_iters", **ref_kw)
        np.testing.assert_array_equal(iters, ref_iters.numpy())
        assert iters[-3] == 0 and iters[-1] == 6 and 0 < iters[-2] < 6
    assert mq.compressed_state(code.qc, "min-sum", "flooding")


def test_compressed_flooding_loop_matches_pallas_interpret():
    """Integer LLRs, α in {1, 0.5} and β in {0, 1}: every message and sum
    is exact, so the compressed flooding loop equals JAX's Pallas kernel
    (interpret mode, one 128-lane tile) exactly."""
    llr = integer_llrs(128, seed=13)
    kw = dict(iterations=3, alpha=(1.0, 0.5, 0.5), beta=(0.0, 1.0, 0.0))
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr), jax_get_code("wifi648").qc,
                                  interpret=True, output="posterior", **kw))
    ours, _ = emulate_kernel(llr, get_code("wifi648").qc, clamp=None,
                             layered=False, compressed=True, **kw)
    np.testing.assert_array_equal(ours, ref)


@functools.cache
def cached_code(name):
    """get_code, built once per test process (the 5G-class codes' girth
    search takes seconds)."""
    return get_code(name)


def flood_plan(qc, word_bits=8):
    """The launcher's FloodPlan (csrc/minsum_qc.cu, bp_qc_launch) from the
    wrapper's plan table: row_ptr; per plane (col·z, shift, row·z, slot);
    col_ptr; per column entry (row·z, shift, slot bits, plane), the slot
    bits the entry's sign bit and its slot in the word's index field
    (above ``word_bits`` sign bits: 8 for the narrow word, 24 for the
    wide one)."""
    row_ptr, col, shift, col_ptr, col_planes = unpack_plan(qc)
    z = qc.z
    row_of = np.repeat(np.arange(qc.mb), np.diff(row_ptr))
    slot = np.arange(len(col)) - row_ptr[row_of]
    plane = np.stack([col * z, shift, row_of * z, slot], 1)
    cols = np.stack([plane[col_planes, 2], plane[col_planes, 1],
                     (1 << slot[col_planes])
                     | (slot[col_planes] << word_bits),
                     col_planes], 1)
    return row_ptr, plane, col_ptr, cols


def warp_walk(z, threads, blocks):
    """WarpWalk (csrc/minsum_qc.cu) for each warp of a CTA of ``threads``:
    its tasks (b, lanes) over ``blocks`` blocks of z checks or variables,
    lanes the offsets 32k .. 32k+31 below z of its chunk k."""
    chunks, nw = -(-z // 32), threads // 32
    walks = []
    for w in range(nw):
        b, k = divmod(w, chunks)
        db, dk = divmod(nw, chunks)
        tasks = []
        while b < blocks:
            lanes = np.arange(32 * k, 32 * k + 32)
            tasks.append((b, lanes[lanes < z]))
            b, k = b + db, k + dk
            if k >= chunks:
                b, k = b + 1, k - chunks
        walks.append(tasks)
    return walks


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc8448_r12",
                                  "qc12288_r12"])
def test_warp_walks_visit_in_plain_order(name):
    """The flooding walks of every CTA size the wrapper launches (and the
    layered CTA's, whose rebuild and counts walk the same way) visit every
    check and every variable once; a check's slots meet the variables of
    its row of H in column order, and a variable's FloodPlan entries its
    checks in check-sorted order, the plain version's rebuild order."""
    code = cached_code(name)
    qc = code.qc
    z = qc.z
    row_ptr, plane, col_ptr, cols = flood_plan(qc)
    for threads in (32, 128, 256, 512, 1024, -(-z // 32) * 32):
        for blocks in (qc.mb, qc.nb):
            seen = np.zeros(blocks * z, np.int64)
            for tasks in warp_walk(z, threads, blocks):
                for b, lanes in tasks:
                    seen[b * z + lanes] += 1
            assert (seen == 1).all(), (threads, blocks)
    H = code.H
    for b in range(qc.mb):
        pl = plane[row_ptr[b]:row_ptr[b + 1]]
        r = np.arange(z)[:, None]
        slots = pl[:, 0] + (r + pl[:, 1]) % z  # (z, degree) variables
        want = [np.flatnonzero(H[b * z + i]) for i in range(z)]
        assert all((slots[i] == want[i]).all() for i in range(z))
    for j in range(qc.nb):
        cp = cols[col_ptr[j]:col_ptr[j + 1]]
        q = np.arange(z)[:, None]
        checks = cp[:, 0] + (q - cp[:, 1]) % z  # (z, degree) checks
        want = [np.flatnonzero(H[:, j * z + i]) for i in range(z)]
        assert all((checks[i] == want[i]).all() for i in range(z))
        # the entry's plane and slot are its check's: the plain version's
        # message of that edge
        assert (plane[cp[:, 3], 2] == cp[:, 0]).all()
        assert (1 << plane[cp[:, 3], 3] == cp[:, 2] & 0xFF).all()


def emulate_sumproduct_sr(llr, qc, iterations, layered, msg_qbits=None,
                          msg_qclip=20.0, clamp=None, dtype=torch.float32,
                          weights=None, threads=256, lt_wide=False,
                          every=False):
    """The sum-product _sr kernels (csrc/minsum_qc.cu: sp_check,
    iterate_sr, rebuild_sr) in torch, with the plain version's exp,
    expm1, log1p and log, vectorized over a block row's threads (layered)
    or a warp task's lanes (flooding) and the batch. A check's slots are
    unrolled: pass 1 keeps each slot's old message, posterior, v2c and
    weight as registers, then each slot's lt, and sums the row left to
    right; pass 2 forms each magnitude and message from the registers and
    stores the message and, layered, the posterior. Flooding
    walks warps over (block row, 32 checks), then over (column block, 32
    variables) for the rebuild from the LLRs in the posterior's storage.
    On the codes beyond the narrow limits by their row degree alone the
    serial-C loop is the _rw kernels', each row's slots unrolled to its
    degree (8-18; the kernel reads a slot's old message and posterior
    again in pass 2, the same values), the plan's entries packed for the
    wide word as the launcher packs them. ``lt_wide``: flooding runs the
    _lw kernels' check and CTA instead (:func:`emulate_sumproduct_lw`).
    Returns the posterior, log(Pr1/Pr0); with ``every``, the LLRs as the
    posterior holds them and each iteration's posterior."""
    f32 = torch.float32
    row_ptr, plane, col_ptr, cols = flood_plan(
        qc, 8 if mq._within_limits(qc) else mq.WIDE_LIMITS[0])
    z, mb, nb = qc.z, qc.mb, qc.nb
    x = torch.from_numpy(llr)
    B = x.shape[0]
    big = torch.tensor(math.inf if clamp is None else clamp, dtype=f32)
    qstep = None if msg_qbits is None else torch.tensor(
        2.0 * msg_qclip / (2**msg_qbits - 1), dtype=f32)
    qclip = torch.tensor(msg_qclip, dtype=f32)
    sstep = torch.tensor(2.0 * msg_qclip / 255.0, dtype=f32)
    sinv = torch.tensor(1.0 / (2.0 * msg_qclip / 255.0), dtype=f32)

    def store_msg(v):  # lift(store<Msg>(v)); an int8 zero code lifts to +0
        if dtype == torch.bfloat16:
            return v.to(torch.bfloat16).to(f32)
        if dtype == torch.int8:
            return (torch.clamp(torch.round(v * sinv), -127.0, 127.0)
                    + 0.0) * sstep
        return v

    def store_post(v):
        return v.to(torch.bfloat16).to(f32) if dtype == torch.bfloat16 else v

    def sp_lt(v):
        a = torch.clamp_min(v.abs(), 1e-12)
        return torch.log(-torch.expm1(-a)) - torch.log1p(torch.exp(-a))

    def sp_mag(s):
        return torch.log1p(torch.exp(s)) - torch.log(-torch.expm1(s))

    def postlude(y):
        y = torch.minimum(torch.maximum(y, -big), big)
        if qstep is not None:
            y = torch.round(y / qstep) * qstep
            y = torch.minimum(torch.maximum(y, -qclip), qclip)
        return y

    wm = wl = None
    if weights is not None:
        wt = pack_edge_weights(weights, qc, iterations)
        wm, wl = wt.msg, wt.llr.reshape(iterations + 1, -1)

    def check(msg, post, it, i, rs):
        """sp_check of the checks rs of block row i."""
        p0, deg = row_ptr[i], row_ptr[i + 1] - row_ptr[i]
        pv, old, x, wv = [], [], [], []
        negs = torch.zeros((B, rs.size), dtype=torch.int64)
        for e in range(deg):
            cx, s = plane[p0 + e, :2]
            vi = torch.from_numpy(cx + (rs + s) % z)
            old.append(msg[p0 + e][:, rs])
            m = old[e]
            if wm is not None:
                wv.append(wm[it, p0 + e, rs])
                m = wv[e] * m
            pv.append(post[:, vi])
            v = pv[e] - m
            if not layered:
                v = store_msg(v)
            negs |= (v < 0).to(torch.int64) << e
            x.append(v)
        x = [sp_lt(v) for v in x]
        total = torch.zeros((B, rs.size), dtype=f32)
        for e in range(deg):
            total = total + x[e]
        x = [sp_mag(torch.clamp_max(total - t, -1e-12)) for t in x]
        odd = sum((negs >> e) & 1 for e in range(deg)) & 1
        for e in range(deg):
            sgn = torch.where(((negs >> e) & 1) ^ odd == 1, -1.0, 1.0)
            y = postlude(sgn * x[e])
            stored = store_msg(y)
            msg[p0 + e][:, rs] = stored
            if layered:
                if dtype == torch.int8:
                    y = stored
                d = y - old[e]
                if wm is not None:
                    d = wv[e] * d
                cx, s = plane[p0 + e, :2]
                post[:, torch.from_numpy(cx + (rs + s) % z)] = \
                    store_post(pv[e] + d)

    def rebuild(msg, lv, row):
        post = torch.empty_like(lv)
        for tasks in warp_walk(z, threads, nb):
            for j, qs in tasks:
                v = torch.from_numpy(j * z + qs)
                acc = lv[:, v]
                if wl is not None:
                    acc = wl[row, v] * acc
                for cx, s, _, p in cols[col_ptr[j]:col_ptr[j + 1]]:
                    r = torch.from_numpy((qs - s) % z)
                    m = msg[p][:, r]
                    acc = acc + (m if wm is None else wm[row, p, r] * m)
                post[:, v] = store_post(acc)
        return post

    def check_lw(msg, lts, post, it, i, rs):
        """lw_check of the checks rs of block row i: pass 1, two slots a
        call, each slot's v2c through the storage, its sign a bit of negs,
        its lt written over its message (f32) or into lts; pass 2 reads
        each lt back."""
        p0, deg = row_ptr[i], row_ptr[i + 1] - row_ptr[i]
        at = msg if dtype == torch.float32 else lts
        negs = torch.zeros((B, rs.size), dtype=torch.int64)
        total = torch.zeros((B, rs.size), dtype=f32)
        for e0 in range(0, deg, 2):
            pair = range(e0, min(e0 + 2, deg))
            vs = []
            for e in pair:
                cx, s = plane[p0 + e, :2]
                m = msg[p0 + e][:, rs]
                if wm is not None:
                    m = wm[it, p0 + e, rs] * m
                vs.append(store_msg(
                    post[:, torch.from_numpy(cx + (rs + s) % z)] - m))
            for e, v in zip(pair, vs):
                negs |= (v < 0).to(torch.int64) << e
                t = sp_lt(v)
                total = total + t
                at[p0 + e][:, rs] = t
        odd = sum((negs >> e) & 1 for e in range(deg)) & 1
        for e in range(deg):
            mag = sp_mag(torch.clamp_max(total - at[p0 + e][:, rs], -1e-12))
            sgn = torch.where(((negs >> e) & 1) ^ odd == 1, -1.0, 1.0)
            msg[p0 + e][:, rs] = store_msg(postlude(sgn * mag))

    lv = store_post(-x)  # (B, n): the LLRs as the posterior holds them
    msg = [torch.zeros((B, z), dtype=f32) for _ in range(len(plane))]
    lts = [torch.zeros((B, z), dtype=f32) for _ in range(len(plane))]
    post = lv.clone() if wm is None else rebuild(msg, lv, 0)
    if layered:
        threads = -(-z // 32) * 32
    posts = []
    for it in range(iterations):
        if layered:
            for i in range(mb):
                check(msg, post, it, i, np.arange(z))
            if wm is not None:
                post = rebuild(msg, lv, it + 1)
        elif lt_wide:
            # threads lane-dense over the checks: a block row's z checks at
            # once (the checks are independent, so any order gives these
            # values)
            for i in range(mb):
                check_lw(msg, lts, post, it, i, np.arange(z))
            post = rebuild(msg, lv, it + 1)
        else:
            for tasks in warp_walk(z, threads, mb):
                for i, rs in tasks:
                    check(msg, post, it, i, rs)
            post = rebuild(msg, lv, it + 1)
        posts.append(-post)
    if every:
        return lv, posts
    return (-post).numpy()


def emulate_sumproduct_lw(llr, code, iterations, msg_qbits=None,
                          msg_qclip=20.0, clamp=None, dtype=torch.float32,
                          weights=None, early_stop_k=None):
    """The wide rows' sum-product flooding _lw kernels (csrc/minsum_qc.cu:
    lw_check, iterate_lw) in torch: each check's slots in a loop two at a
    time, pass 1 keeping its lt values over its own messages (f32) or
    apart (bf16, int8: the kernel's local array or f32 scratch) and its
    signs in one word, pass 2 reading them back; then the posterior
    rebuilt in the plain version's order. Returns the posterior (log
    Pr1/Pr0), or with
    ``early_stop_k`` = K (the _es forms: the syndrome checked at entry and
    after every K-th iteration, a codeword frozen at its first satisfying
    state) the hard bits and the iterations each codeword ran."""
    kw = dict(msg_qbits=msg_qbits, msg_qclip=msg_qclip, clamp=clamp,
              dtype=dtype, weights=weights, lt_wide=True)
    if early_stop_k is None:
        return emulate_sumproduct_sr(llr, code.qc, iterations, False, **kw)
    lv, posts = emulate_sumproduct_sr(llr, code.qc, iterations, False,
                                      every=True, **kw)
    H = torch.from_numpy(np.asarray(code.H, np.float32))

    def satisfied(p):  # p: log Pr1/Pr0
        bits = (p > 0).to(torch.float32)
        return torch.remainder(bits @ H.T, 2.0).sum(1) == 0

    out, ran = -lv, torch.full((llr.shape[0],), iterations,
                               dtype=torch.int32)
    done = satisfied(out)
    ran[done] = 0
    for r in range(iterations // early_stop_k):
        p = posts[(r + 1) * early_stop_k - 1]
        now = ~done & satisfied(p)
        out = torch.where(now[:, None], p, out)
        ran[now] = (r + 1) * early_stop_k
        done |= now
    out = torch.where(done[:, None], out, posts[-1])
    return (out > 0).to(torch.int8).numpy(), ran.numpy()


def saturated_llrs(code, batch, seed):
    """Consistent-Gaussian LLRs of random codewords (log Pr1/Pr0), their
    mean rising from 1 to 6 over the rows; row 0 its codeword at |LLR| =
    60, row 1 at 60 with random signs (every check in conflict)."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    mu = np.linspace(1.0, 6.0, batch)[:, None]
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, 1, cw.shape) * np.sqrt(2 * mu)
    llr[0] = (2.0 * cw[0] - 1.0) * 60.0
    llr[1] = np.where(rng.random(code.n) < 0.5, -60.0, 60.0)
    return np.ascontiguousarray(llr, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("qbits", [None, 5], ids=["", "msgq5"])
@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
def test_sumproduct_registers_loop_matches_plain_version(layered, qbits,
                                                         dtype):
    """The sum-product _sr loops (slots unrolled, the row summed left to
    right, pass 2 from registers, the flooding walks) equal decode_roll's
    sum-product exactly on every row but the conflicted saturated one,
    which both keep finite (there Σlt − lt cancels to a few ulps of one
    large lt). 32 codewords of wifi648: every tensor a multiple of 32
    elements, so no operation takes a scalar tail."""
    code = get_code("wifi648")
    llr = saturated_llrs(code, 32, seed=21)
    kw = dict(iterations=2, msg_qbits=qbits, msg_qclip=20.0, dtype=dtype,
              clamp=20.0)
    ours = emulate_sumproduct_sr(llr, code.qc, layered=layered, **kw)
    ref = decode_roll(torch.from_numpy(llr), code.qc, output="posterior",
                      method="sum-product",
                      schedule="layered" if layered else "flooding",
                      **kw).numpy()
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(ours[rows], ref[rows])
    assert mq.sumproduct_registers(code.qc, "sum-product",
                                   "layered" if layered else "flooding")


@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
def test_sumproduct_registers_weighted_loop_matches_plain_version(layered):
    """The weighted _sr loops (w·old in the v2c, w·(new − old) folded,
    the rebuild with the next row's weights) exactly equal decode_roll,
    at a CTA of 128 threads (four warps walking the flooding passes)."""
    code = get_code("wifi648")
    llr = saturated_llrs(code, 32, seed=22)
    rng = np.random.default_rng(23)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in init_neural_bp_weights(code, 2).items()}
    ours = emulate_sumproduct_sr(llr, code.qc, 2, layered, weights=w,
                                 threads=128)
    ref = decode_roll(torch.from_numpy(llr), code.qc, iterations=2,
                      output="posterior", method="sum-product", weights=w,
                      schedule="layered" if layered else "flooding").numpy()
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(ours[rows], ref[rows])


def test_sumproduct_registers_loop_matches_pallas_interpret():
    """The layered _sr loop against JAX's Pallas kernel in interpret mode
    (one 128-lane tile of wifi648), at the tolerance JAX holds that kernel
    to its roll backend: the TPU kernel takes log(1 − e^−a) as a series
    where the port calls expm1."""
    rng = np.random.default_rng(24)
    llr = rng.normal(0, 3, (128, 648)).astype(np.float32)
    kw = dict(iterations=2, clamp=20.0)
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr),
                                  jax_get_code("wifi648").qc, interpret=True,
                                  method="sum-product", schedule="layered",
                                  output="posterior", **kw))
    ours = emulate_sumproduct_sr(llr, get_code("wifi648").qc, layered=True,
                                 **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name, fits", [
    ("wifi648", True), ("wifi1944", True), ("qc8448_r12", True),
    ("qc12288_r12", True), ("qc1944_r23", False), ("qc648_r56", False),
    ("degree-10", None)])
def test_sumproduct_registers_selection(name, fits):
    """Which decodes keep a sum-product check's slots in registers: every
    sum-product decode on a code within the register arrays' 8 slots and
    the parameter plan's limits, flooding and serial-C (G = 1) on the _sr
    kernels, group-serial (G > 1) on the _gs kernels; beyond them by the
    row degree alone (``fits`` False) serial-C and group-serial on the wide
    rows (_rw, _gw) and flooding on the _lw kernels (one lt an edge, not
    in registers), and a code with a row of a degree no wide body has
    (``fits`` None) the full-message kernels at every G. Min-sum keeps its
    compressed state (_cs, and _gs for G > 1) within the limits and on the
    wide rows its wide word (_cw, and _gw for G > 1)."""
    qc = degree10_qc() if fits is None else cached_code(name).qc
    rows = "" if fits else "-wide"
    for sched, G in (("flooding", 1), ("layered", 1), ("layered", 2),
                     ("layered", 4)):
        group = G > 1
        full = fits is None
        lt = fits is False and sched == "flooding"
        assert mq.sumproduct_registers(qc, "sum-product", sched, G) == (
            not full and not lt)
        assert not mq.sumproduct_registers(qc, "min-sum", sched, G)
        kind = mq.design(qc, "sum-product", sched, G)
        want = "full" if full else "lt-wide" if lt else (
            ("group" if group else "registers") + rows)
        assert kind == want
        entry = mq.entry_point(qc, "sum-product", sched, dtype=torch.int8,
                               layered_group=G)
        assert entry == f"sumproduct_qc_{sched}" + mq.DESIGNS[want][1] \
            + "_i8"
        assert mq.design(qc, "min-sum", sched, G) == ("full" if fits is None
                                                      else ("group" if group
                                                            else "compressed")
                                                      + rows)
    sr, cs = {True: ("_sr", "_cs"), False: ("_rw", "_cw"),
              None: ("", "")}[fits]
    assert mq.entry_point(qc, "sum-product", "layered", True, True) == (
        "sumproduct_qc_layered_es_msgq" + sr)
    assert mq.entry_point(qc, "sum-product", "flooding", weighted=True,
                          dtype=torch.bfloat16) == (
        "sumproduct_qc_flooding_w" + {True: "_sr", False: "_lw",
                                      None: ""}[fits] + "_bf16")
    assert mq.entry_point(qc, "min-sum", "layered", True, True) == (
        "minsum_qc_layered_es_msgq" + cs)


def test_launch_table_keys_the_method():
    """The flooding CTA size is looked up per method: sum-product's sweep
    moved wifi648 to 128 threads and the 5G-class int8/bf16 entries, while
    min-sum keeps its own entries and the default 256."""
    w648, w1944 = cached_code("wifi648").qc, cached_code("wifi1944").qc
    assert mq.default_threads(w648) == 256
    assert mq.default_threads(w648, method="sum-product") == 128
    assert mq.default_threads(w1944, torch.bfloat16) == 128
    assert mq.default_threads(w1944, torch.bfloat16,
                              method="sum-product") == 128
    assert mq.default_threads(w1944, method="sum-product") == 256
    assert {k[3] for k in mq._LAUNCH_TABLE} == {"min-sum", "sum-product"}


@pytest.mark.parametrize("kw, match", [
    (dict(schedule="zigzag"), "unknown schedule"),
    (dict(output="soft"), "'hard' or 'posterior'"),
    (dict(alpha=(0.5, 0.5)), "length 4"),
])
def test_wrapper_rejects_bad_arguments(kw, match):
    qc = get_code("wifi648").qc
    with pytest.raises(ValueError, match=match):
        mq.bp_qc_cuda(torch.zeros((2, 648)), qc, iterations=4, **kw)


def test_launch_counters_start_and_reset():
    names = {f"{rule}_qc_{sched}{es}{q}{dt}"
             for rule in ("minsum", "sumproduct")
             for sched in ("flooding", "layered")
             for es in ("", "_es", "_w") for q in ("", "_msgq")
             for dt in ("", "_bf16", "_i8")}
    assert len(names) == 72 and set(mq.LAUNCHES) == names
    assert mq.KERNELS["sum-product", "layered", True, False] == \
        "sumproduct_qc_layered_es"
    assert mq.KERNELS_W["min-sum", "layered", True] == \
        "minsum_qc_layered_w_msgq"
    mq.LAUNCHES["minsum_qc_layered"] += 3
    mq.reset_launch_counts()
    assert mq.LAUNCHES == {name: 0 for name in names}
    # the plain version on the CPU is no launch, whatever the form
    code = get_code("wifi648")
    qc, z = code.qc, torch.zeros((2, 648))
    mq.bp_qc_cuda(z, qc, iterations=2)
    mq.bp_qc_cuda(z, qc, iterations=2, early_stop=True)
    mq.bp_qc_cuda(z, qc, iterations=2, schedule="layered", layered_group=3,
                  weights=init_neural_bp_weights(code, 2))
    mq.bp_qc_probe_requeue(z, qc, iterations=2, probe_iters=1,
                           method="sum-product", msg_qbits=4)
    assert sum(mq.LAUNCHES.values()) == 0
