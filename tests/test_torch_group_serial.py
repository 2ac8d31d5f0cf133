"""The group-serial layered kernels (``layered_group = G > 1``, the ``_gs``
entry points of csrc/minsum_qc.cu) on the CPU: their loop transliterated to
torch, driven by the very host ints the launcher copies into the kernel
parameter (:func:`group_plan`, the plan table), against the plain version;
the plan's invariants on every library code the kernels take; and the
routing of every group-taking form to them.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py phases 2d-2g); what they compute is checked here by running
``iterate_gs`` line for line: warps walk (block row of the group, 32
checks), a private plane's change folds into the posterior at once, a
shared plane's waits in the scratch at its row, then the fold pass walks
the group's shared column blocks alone, adding each variable's changes in
block-row order and rounding to the posterior's storage after each.
Min-sum keeps the compressed check state (two stored magnitudes, the
exclusive-sign bits and the first minimum's slot a check), sum-product its
full messages with a check's slots unrolled. Every comparison with
``decode_roll(layered_group=G)`` is exact; sum-product's saturated row with
conflicting signs only to finiteness, as in tests/test_torch_kernels.py
(there Σlt − lt cancels to a few ulps of one large lt). 32 codewords: every
tensor a multiple of 32 elements, so no CPU operation takes a scalar tail.
The plain version itself is held to JAX's Pallas kernel in interpret mode
at G = 3 and G = mb in tests/test_torch_layered_group.py, on the input
:func:`test_group_serial_loop_on_the_pallas_input` runs here.
"""

import functools

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.codes import get_code, list_codes
from ldpc_sims_tpu_torch.codes.library import QcStructure
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import init_neural_bp_weights
from ldpc_sims_tpu_torch.ops.bp_roll import (
    decode_roll,
    pack_edge_weights,
    qc_plan,
)

F32 = torch.float32
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@functools.cache
def cached_code(name):
    """get_code, built once per test process (the 5G-class codes' girth
    search takes seconds)."""
    return get_code(name)


def degree10_qc():
    """qc1944_r34's base (z = 81) with the circulant of its second block
    row's first column dropped: 66 planes, rows of degree 10-12, a degree
    (10) no body of the wide rows has (chip_smoke.py's degree10_code)."""
    base = [list(r) for r in cached_code("qc1944_r34").qc.base]
    assert sum(s >= 0 for s in base[1]) == 11 and base[1][0] >= 0
    base[1][0] = -1
    return QcStructure(z=81, base=tuple(tuple(r) for r in base))


def parse_group_plan(qc, G):
    """The launcher's GroupPlan from group_plan's host ints (csrc/
    minsum_qc.cu, bp_qc_launch): header, fold_ptr, scratch, fold
    entries."""
    gp = mq.group_plan(qc, G)
    P = len(qc_plan(qc)[0])
    G_, groups, folds, shared, widest = (int(x) for x in gp[:5])
    at = 5
    fold_ptr = gp[at:at + groups + 1]
    at += groups + 1
    scratch = gp[at:at + P]
    at += P
    fold = gp[at:at + 3 * folds].reshape(folds, 3)
    assert at + 3 * folds == gp.size
    return dict(G=G_, groups=groups, shared=shared, widest=widest,
                fold_ptr=fold_ptr, scratch=scratch, fold=fold)


def param_plan(qc):
    """The plan table's rows and columns as the launcher's FloodPlan holds
    them: row_ptr; per plane (col·z, shift, row·z, slot); col_ptr; per
    column entry its plane, by block row."""
    t = mq._plan_array(qc)
    mb, nb, z = qc.mb, qc.nb, qc.z
    P = int(t[mb])
    row_ptr = t[:mb + 1]
    col, shift = t[mb + 1:mb + 1 + P], t[mb + 1 + P:mb + 1 + 2 * P]
    col_ptr = t[mb + 1 + 2 * P:mb + 2 + 2 * P + nb]
    col_planes = t[mb + 2 + 2 * P + nb:]
    row_of = np.repeat(np.arange(mb), np.diff(row_ptr))
    slot = np.arange(P) - row_ptr[row_of]
    plane = np.stack([col * z, shift, row_of * z, slot], 1)
    return row_ptr, plane, col_ptr, col_planes


def warp_tasks(z, warps, rows):
    """WarpWalk over (block row, 32 checks) for a CTA of ``warps`` warps,
    the rows ``rows`` (a group's), in the order of all the warps' walks:
    each task (row, lanes) once."""
    chunks = -(-z // 32)
    tasks = []
    for w in range(warps):
        b, k = divmod(w, chunks)
        db, dk = divmod(warps, chunks)
        b += rows.start
        while b < rows.stop:
            lanes = np.arange(32 * k, 32 * k + 32)
            tasks.append((b, lanes[lanes < z]))
            b, k = b + db, k + dk
            if k >= chunks:
                b, k = b + 1, k - chunks
    return tasks


def emulate_group_serial(llr, qc, G, iterations, method="min-sum",
                         alpha=1.0, beta=0.0, clamp=None, msg_qbits=None,
                         msg_qclip=20.0, dtype=torch.float32, weights=None,
                         early_stop=False, check_every=1, word_bits=8):
    """The _gs kernels (csrc/minsum_qc.cu: iterate_gs with gs_check_cs for
    min-sum on the compressed state, sp_check with kFoldGroup for
    sum-product, the fold pass, the weighted re-base) in torch, vectorized
    over a warp task's lanes and the batch; with ``word_bits=24`` the _gw
    kernels, min-sum's word the wide one (24 sign bits). Returns the
    posterior (log Pr1/Pr0) and, with early stop, the iterations run."""
    gp = parse_group_plan(qc, G)
    row_ptr, plane, col_ptr, col_planes = param_plan(qc)
    z, mb, nb = qc.z, qc.mb, qc.nb
    P = len(plane)
    G = gp["G"]
    # the launcher's CTA at wifi648 and wifi1944: sum-product a warp for
    # each 32 checks of a group (at most 32), min-sum one block row's warps
    # (the walks give the same result for any count)
    chunks = -(-z // 32)
    warps = chunks if method == "min-sum" else min(G * chunks, 32)
    x = torch.from_numpy(llr)
    B = x.shape[0]
    compressed = method == "min-sum"
    ab = mq._ab_table(alpha, beta, iterations)
    big = torch.tensor(np.inf if clamp is None else clamp, dtype=F32)
    qstep = None if msg_qbits is None else torch.tensor(
        2.0 * msg_qclip / (2**msg_qbits - 1), dtype=F32)
    qclip = torch.tensor(msg_qclip, dtype=F32)
    sstep = torch.tensor(2.0 * msg_qclip / 255.0, dtype=F32)
    sinv = torch.tensor(1.0 / (2.0 * msg_qclip / 255.0), dtype=F32)
    int8 = dtype == torch.int8

    def code_of(v):  # store<Msg>: bf16 and f32 their value, int8 its code
        if dtype == torch.bfloat16:
            return v.to(torch.bfloat16).to(F32)
        if int8:  # an integer code: a -0 is the code 0
            return torch.clamp(torch.round(v * sinv), -127.0, 127.0) + 0.0
        return v

    def lift(c):
        return c * sstep if int8 else c

    def store_post(v):
        return v.to(torch.bfloat16).to(F32) if dtype == torch.bfloat16 else v

    def postlude(y):
        y = torch.minimum(torch.maximum(y, -big), big)
        if qstep is not None:
            y = torch.round(y / qstep) * qstep
            y = torch.minimum(torch.maximum(y, -qclip), qclip)
        return y

    def sp_lt(v):
        a = torch.clamp_min(v.abs(), 1e-12)
        return torch.log(-torch.expm1(-a)) - torch.log1p(torch.exp(-a))

    def sp_mag(s):
        return torch.log1p(torch.exp(s)) - torch.log(-torch.expm1(s))

    wm = wl = None
    if weights is not None:
        wt = pack_edge_weights(weights, qc, iterations)
        wm, wl = wt.msg, wt.llr.reshape(iterations + 1, -1)

    def message(state, p, rs):
        """Plane p's messages of its checks rs: the full message, or on the
        compressed state its magnitude code with its slot's sign (f32 and
        bf16 negate the value, keeping -0; int8 the code, so a zero code
        lifts to +0)."""
        if not compressed:
            return state[p][:, rs]
        i, e = plane[p, 2] // z, plane[p, 3]
        m1, m2, signs, first = (s[i][:, rs] for s in state)
        code = torch.where(first == e, m2, m1)
        code = torch.where((signs >> e) & 1 == 1, -code, code)
        return lift(code + 0.0 if int8 else code)

    def check(state, post, delta, it, i, rs):
        """gs_check_cs / sp_check<kFoldGroup> of the checks rs of row i."""
        a, b = (torch.tensor(float(t), dtype=F32) for t in ab[it])
        p0, deg = row_ptr[i], row_ptr[i + 1] - row_ptr[i]
        shape = (post.shape[0], rs.size)
        pv, old, wv, xs = [], [], [], []
        negs = torch.zeros(shape, dtype=torch.int64)
        min1 = torch.full(shape, 1e30, dtype=F32)
        min2 = torch.full(shape, 1e30, dtype=F32)
        idx = torch.full(shape, -1, dtype=torch.int64)
        for e in range(deg):
            cz, s = plane[p0 + e, :2]
            old.append(message(state, p0 + e, rs))
            m = old[e]
            if wm is not None:
                wv.append(wm[it, p0 + e, rs])
                m = wv[e] * m
            pv.append(post[:, torch.from_numpy(cz + (rs + s) % z)])
            v = pv[e] - m
            negs |= (v < 0).to(torch.int64) << e
            if method == "sum-product":
                xs.append(v)
            else:  # the two minima without a branch, strict
                av = v.abs()
                first = av < min1
                min2 = torch.where(first, min1, torch.minimum(min2, av))
                min1 = torch.where(first, av, min1)
                idx = torch.where(first, e, idx)
        odd = sum((negs >> e) & 1 for e in range(deg)) & 1
        if method == "sum-product":
            lts = [sp_lt(v) for v in xs]
            total = torch.zeros(shape, dtype=F32)
            for t in lts:
                total = total + t
            mags = [sp_mag(torch.clamp_max(total - t, -1e-12)) for t in lts]
            ys = []
            for e in range(deg):
                sgn = torch.where(((negs >> e) & 1) ^ odd == 1, -1.0, 1.0)
                y = postlude(sgn * mags[e])
                stored = code_of(y)
                state[p0 + e][:, rs] = lift(stored + 0.0 if int8 else stored)
                ys.append(state[p0 + e][:, rs] if int8 else y)
        else:  # cs_finish: T of both minima, the signs, the first slot
            def T(mn):
                return postlude(torch.clamp_min(mn - b, 0.0) * a)

            t1, t2 = T(min1), T(min2)
            mask = (1 << word_bits) - 1
            signs = negs ^ torch.where(odd == 1, mask, 0)
            first = torch.clamp_min(idx, 0)
            for s, new in zip(state, (code_of(t1), code_of(t2), signs & mask,
                                      first)):
                s[i][:, rs] = new
            if int8:  # the change of the stored message
                ys = [message(state, p0 + e, rs) for e in range(deg)]
            else:  # bf16 and f32: the unrounded change
                ys = [torch.where(((signs >> e) & 1) == 1, -1.0, 1.0)
                      * torch.where(first == e, t2, t1)
                      for e in range(deg)]
        for e in range(deg):
            d = ys[e] - old[e]
            if wm is not None:
                d = wv[e] * d
            cz, s = plane[p0 + e, :2]
            q = (rs + s) % z  # the slot's variables' offsets
            sc = gp["scratch"][p0 + e]
            if sc >= 0:  # shared: to the scratch, at the variable's offset
                delta[:, torch.from_numpy(sc + q)] = d
            else:  # private: into the posterior at once
                post[:, torch.from_numpy(cz + q)] = store_post(pv[e] + d)

    def fold_pass(post, delta, g):
        for f in range(gp["fold_ptr"][g], gp["fold_ptr"][g + 1]):
            cz, r0, count = gp["fold"][f]
            acc = post[:, cz:cz + z]
            for k in range(count):  # consecutive rows, by block row
                acc = store_post(acc + delta[:, r0 + k * z:r0 + (k + 1) * z])
            post[:, cz:cz + z] = acc

    def rebuild(state, lv, row):
        """The re-base: (wl·) LLR + Σ (w·) messages in check-sorted order,
        rounded once."""
        post = torch.empty_like(lv)
        for j in range(nb):
            v = slice(j * z, (j + 1) * z)
            acc = wl[row, v] * lv[:, v]
            for p in col_planes[col_ptr[j]:col_ptr[j + 1]]:
                r = (np.arange(z) - plane[p, 1]) % z
                acc = acc + wm[row, p, r] * message(state, p, r)
            post[:, v] = store_post(acc)
        return post

    def unsat(post):
        count = torch.zeros(post.shape[0], dtype=torch.int64)
        for i in range(mb):
            parity = torch.zeros((post.shape[0], z), dtype=torch.int64)
            for p in range(row_ptr[i], row_ptr[i + 1]):
                cz, s = plane[p, :2]
                v = torch.from_numpy(cz + (np.arange(z) + s) % z)
                parity ^= (post[:, v] < 0).to(torch.int64)
            count += parity.sum(1)
        return count

    zero = code_of(torch.zeros((B, z), dtype=F32))
    if compressed:
        state = [[zero.clone() for _ in range(mb)],
                 [zero.clone() for _ in range(mb)],
                 [torch.zeros((B, z), dtype=torch.int64) for _ in range(mb)],
                 [torch.zeros((B, z), dtype=torch.int64) for _ in range(mb)]]
    else:
        state = [lift(zero).clone() for _ in range(P)]
    lv = store_post(-x)  # (B, n): the LLRs as the posterior holds them
    post = lv.clone() if wm is None else rebuild(state, lv, 0)
    iters = torch.full((B,), iterations, dtype=torch.int32)
    out = torch.zeros_like(post)
    active = torch.arange(B)

    def keep(rows):
        nonlocal state, post, lv, active
        if compressed:
            state = [[t[rows] for t in s] for s in state]
        else:
            state = [t[rows] for t in state]
        post, lv, active = post[rows], lv[rows], active[rows]

    K = check_every
    for r in range(-1, iterations // K):
        if r >= 0:
            for k in range(K):
                it = r * K + k
                for g, g0 in enumerate(range(0, mb, G)):
                    delta = torch.zeros((post.shape[0], gp["widest"] * z),
                                        dtype=F32)
                    for i, rs in warp_tasks(z, warps,
                                            range(g0, min(g0 + G, mb))):
                        check(state, post, delta, it, i, rs)
                    fold_pass(post, delta, g)
                if wm is not None:
                    post = rebuild(state, lv, it + 1)
        if not early_stop:
            continue
        ok = unsat(post) == 0  # the CTAs that leave the loop
        out[active[ok]] = post[ok]
        iters[active[ok]] = (r + 1) * K
        keep(~ok)
        if active.numel() == 0:
            break
    out[active] = post
    return (-out).numpy(), iters.numpy()


def integer_llrs(code, batch, seed):
    """LLRs in {-3, ..., 3}: tied minima, zero magnitudes and an offset
    above the minimum are common (the inputs a compressed state could get
    wrong)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, (batch, code.n)).astype(np.float32)


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


def regimes_llrs(code, batch, seed):
    """LLRs whose mean grows from 0.5 to 12 over the rows, the last three
    noiseless at |LLR| = 12: some codewords pass at entry, some converge
    after a few iterations, some never."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    mu = np.linspace(0.5, 12.0, batch)[:, None]
    x = (2.0 * cw - 1.0) * mu + rng.normal(0, 1, cw.shape) * np.sqrt(2 * mu)
    x[-3:] = (2.0 * cw[-3:] - 1.0) * 12.0
    return np.ascontiguousarray(x, np.float32)


def held_to_plain(llr, qc, G, kw, sum_product):
    """The emulation against decode_roll(layered_group=G), exactly (the
    conflicted saturated row of a sum-product input to finiteness)."""
    ours, _ = emulate_group_serial(llr, qc, G, **kw)
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior",
                      schedule="layered", layered_group=G, **kw).numpy()
    rows = np.arange(llr.shape[0]) != (1 if sum_product else -1)
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_array_equal(ours[rows], ref[rows])


RULES = {
    "min-sum": dict(method="min-sum", alpha=(1.0, 0.75, 0.5),
                    beta=(0.0, 1.0, 2.5), clamp=2.0),
    "sum-product": dict(method="sum-product", clamp=20.0),
}


@pytest.mark.parametrize("G", [2, 3, 4, 5, 12], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_group_serial_loop_matches_plain_version(rule, dtype, G):
    """The _gs loop at each storage type, with and without 3-bit messages,
    on wifi648 at G = 2, 3, 4, 5 (a short last group of two rows) and mb:
    min-sum on integer LLRs with the α/β table, a clamp and β above the
    minimum; sum-product on saturated channel LLRs. Posteriors exactly
    equal to decode_roll(layered_group=G)."""
    code = cached_code("wifi648")
    sp = rule == "sum-product"
    llr = (saturated_llrs(code, 32, seed=31) if sp
           else integer_llrs(code, 32, seed=32))
    for qbits in (None, 3):
        kw = dict(RULES[rule], iterations=3, dtype=DTYPES[dtype],
                  msg_qbits=qbits, msg_qclip=4.0 if not sp else 20.0)
        held_to_plain(llr, code.qc, G, kw, sp)
    assert mq.design(code.qc, rule, "layered", G) == "group"


@pytest.mark.parametrize("G", [3, 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_group_serial_weighted_loop_matches_plain_version(rule, dtype, G):
    """Per-edge weights: w·old in the v2c, w·(new − old) to the posterior
    or the scratch, the re-base with the next row's weights; exactly
    equal, with 4-bit messages."""
    code = cached_code("wifi648")
    sp = rule == "sum-product"
    llr = saturated_llrs(code, 32, seed=33)
    rng = np.random.default_rng(34)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in init_neural_bp_weights(code, 2).items()}
    kw = dict(RULES[rule], iterations=2, dtype=DTYPES[dtype], weights=w,
              msg_qbits=4, msg_qclip=20.0)
    if not sp:
        kw.update(alpha=0.75, beta=(0.0, 1.0))
    held_to_plain(llr, code.qc, G, kw, sp)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_group_serial_early_stop_loop_matches_plain_version(rule, dtype, K):
    """Early stop at K = 1 and 2 under G = 4: posteriors and iteration
    counts exactly equal; the channel's three regimes (passes at entry,
    converges, never) all occur."""
    code = cached_code("wifi648")
    sp = rule == "sum-product"
    llr = regimes_llrs(code, 32, seed=35)
    kw = dict(RULES[rule], iterations=6, dtype=DTYPES[dtype], msg_qclip=20.0)
    if not sp:
        kw.update(alpha=0.8, beta=0.05, clamp=None)
    ours, iters = emulate_group_serial(llr, code.qc, 4, early_stop=True,
                                       check_every=K, **kw)
    x = torch.from_numpy(llr)
    ref_kw = dict(kw, schedule="layered", layered_group=4, early_stop=True,
                  es_check_every=K)
    ref = decode_roll(x, code.qc, output="posterior", **ref_kw).numpy()
    _, ref_iters = decode_roll(x, code.qc, output="hard_iters", **ref_kw)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(iters, ref_iters.numpy())
    assert iters.min() == 0 and iters.max() == 6
    assert ((iters > 0) & (iters < 6)).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_group_serial_loop_wifi1944(rule, dtype):
    """wifi1944 at G = 4 (z = 81: three warps a block row, the third with
    17 lanes; 12 warps a CTA), exactly equal to the plain version."""
    code = cached_code("wifi1944")
    sp = rule == "sum-product"
    llr = (saturated_llrs(code, 32, seed=36) if sp
           else integer_llrs(code, 32, seed=37))
    kw = dict(RULES[rule], iterations=3, dtype=DTYPES[dtype], msg_qclip=4.0)
    held_to_plain(llr, code.qc, 4, kw, sp)


def test_group_serial_loop_on_the_pallas_input():
    """The input tests/test_torch_layered_group.py holds to JAX's Pallas
    kernel in interpret mode (wifi648, N(0, 3²) LLRs, 128 codewords,
    min-sum layered-2 at G = 3): the _gs loop equals the plain version
    exactly there, so it agrees with the Pallas kernel as the plain
    version does."""
    code = cached_code("wifi648")
    rng = np.random.default_rng(0)
    llr = rng.normal(0, 3, (128, code.n)).astype(np.float32)
    ours, _ = emulate_group_serial(llr, code.qc, 3, 2)
    ref = decode_roll(torch.from_numpy(llr), code.qc, iterations=2,
                      schedule="layered", layered_group=3,
                      output="posterior").numpy()
    np.testing.assert_array_equal(ours, ref)


# the library's QC codes, by name (built in the test, not at collection)
QC_CODES = [n for n in list_codes() if n.startswith(("wifi", "qc"))]


@pytest.mark.parametrize("name", QC_CODES)
def test_group_plan_invariants(name):
    """For every G in 2..mb on each library QC code, all of which the
    group-serial kernels take (within COMPRESSED_LIMITS the _gs kernels,
    beyond them by the row degree alone the _gw kernels): each plane
    appears once (in its group's rows); the private planes are exactly
    those alone in their column block within the group; each fold entry is
    a column block of two or more planes of its group, its shared planes
    on consecutive scratch rows in block-row order, the group's rows
    distinct and below the largest group's; the plan fits the kernel
    parameter's arrays."""
    qc = cached_code(name).qc
    kind = "group" if mq._within_limits(qc) else "group-wide"
    assert kind == "group" or mq._within_limits(qc, wide=True)
    for rule in ("min-sum", "sum-product"):
        assert mq.design(qc, rule, "layered", 2) == kind
    planes, group_c, _ = qc_plan(qc)
    z = qc.z
    max_groups, max_folds = mq.GROUP_PLAN_LIMITS
    for G in range(2, qc.mb + 1):
        gp = parse_group_plan(qc, G)
        assert gp["G"] == G and gp["groups"] == -(-qc.mb // G)
        assert gp["groups"] <= max_groups
        assert len(gp["fold"]) <= max_folds
        seen_shared = []
        for g, g0 in enumerate(range(0, qc.mb, G)):
            ps = [p for i in range(g0, min(g0 + G, qc.mb))
                  for p in group_c[i]]
            cols = [planes[p][1] for p in ps]
            for p in ps:  # private iff alone in its column within the group
                alone = cols.count(planes[p][1]) == 1
                assert (gp["scratch"][p] == -1) == alone, (G, p)
            entries = gp["fold"][gp["fold_ptr"][g]:gp["fold_ptr"][g + 1]]
            rows_used = []
            for cz, r0, count in entries:
                j = cz // z
                assert cz == j * z and cols.count(j) >= 2
                want = [p for p in ps if planes[p][1] == j]  # by block row
                assert count == len(want)
                for k, p in enumerate(want):
                    assert gp["scratch"][p] == r0 + k * z and r0 % z == 0
                    rows_used.append(r0 // z + k)
                    seen_shared.append(p)
            assert sorted(rows_used) == list(range(len(rows_used)))
            assert len(rows_used) <= gp["widest"]
            assert {cz // z for cz, _, _ in entries} == {
                j for j in cols if cols.count(j) >= 2}
        assert sorted(seen_shared) == sorted(
            p for p in range(len(planes)) if gp["scratch"][p] >= 0)
        assert len(set(seen_shared)) == len(seen_shared) == gp["shared"]
    # a G above mb is taken as mb
    assert np.array_equal(mq.group_plan(qc, qc.mb + 3),
                          mq.group_plan(qc, qc.mb))


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc12288_r12"])
def test_group_walks_visit_each_check_once(name):
    """The check walk of each CTA size the launcher takes (one block row's
    warps, a warp for each 32 checks of a group up to 32, and one warp)
    visits each check of each group once, and no other."""
    qc = cached_code(name).qc
    z, chunks = qc.z, -(-qc.z // 32)
    for G in (2, 3, 4, 5, qc.mb):
        for warps in {1, chunks, min(G * chunks, 32)}:
            for g0 in range(0, qc.mb, G):
                rows = range(g0, min(g0 + G, qc.mb))
                seen = np.zeros((qc.mb, z), np.int64)
                for i, lanes in warp_tasks(z, warps, rows):
                    seen[i, lanes] += 1
                assert (seen[g0:rows.stop] == 1).all(), (G, warps, g0)
                assert seen.sum() == len(rows) * z


def test_group_plan_fits_the_kernel_parameter():
    """The GroupPlan struct, its arrays sized for the largest code within
    COMPRESSED_LIMITS, takes 9,136 B, within the 32,764 B a kernel's
    parameters may take on sm_90; a G below 2 has no plan."""
    assert mq.group_plan_bytes() == 9_136
    assert mq.group_plan_bytes() <= mq.PARAM_BYTES_LIMIT
    qc = cached_code("wifi648").qc
    with pytest.raises(ValueError, match="G ≥ 2"):
        mq.group_plan(qc, 1)


def test_group_plan_beyond_the_parameter_raises():
    """A plan with more groups than the parameter's arrays hold raises,
    naming the limit (no code within COMPRESSED_LIMITS gets there: 64 block
    rows make at most 32 groups of G ≥ 2)."""
    qc = QcStructure(z=4, base=((0, 0),) * 66)  # 66 block rows
    with pytest.raises(ValueError, match="at most 32"):
        mq.group_plan(qc, 2)


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc1944_r23",
                                  "degree-10"])
def test_group_serial_routing(name):
    """Every group-taking form of both rules at each storage type routes a
    G in 2..mb on a code within the limits to the _gs entry points (G = 1
    and G that covers a one-row group stay serial-C); a code beyond the
    limits by its row degree alone (qc1944_r23, rows of degree 8-9) to
    the _gw entry points, and at G = 1 to the wide word's _cw kernel
    (min-sum) or the _rw kernel (sum-product); a code with a row of a
    degree no wide body has (qc1944_r34's base with one circulant dropped)
    keeps the full-message kernels. The scratch counts the largest group's
    shared planes only."""
    qc = degree10_qc() if name == "degree-10" else cached_code(name).qc
    fits = name != "degree-10"
    want, sfx_g = {"qc1944_r23": ("group-wide", "_gw"),
                   "degree-10": ("full", "")}.get(name, ("group", "_gs"))
    for rule in RULES:
        for G in (2, 4, qc.mb, qc.mb + 1):
            kind = mq.design(qc, rule, "layered", G)
            assert kind == want
            for es, q, w in ((False, False, False), (True, False, False),
                             (False, True, False), (True, True, False),
                             (False, False, True), (False, True, True)):
                for dt, sfx in (("f32", ""), ("bf16", "_bf16"),
                                ("int8", "_i8")):
                    entry = mq.entry_point(qc, rule, "layered", es, q, w,
                                           DTYPES[dt], G)
                    base = mq.kernel_name(rule, "layered", es, q, w)
                    assert entry == base + sfx_g + sfx
        assert mq.design(qc, rule, "layered", 1) not in mq.GROUP_DESIGNS
        if name == "qc1944_r23":
            assert mq.design(qc, rule, "layered", 1) == (
                "compressed-wide" if rule == "min-sum" else "registers-wide")
    if fits:
        assert mq.compressed_state(qc, "min-sum", "layered", 4)
        assert mq.sumproduct_registers(qc, "sum-product", "layered", 4)
        widest = int(mq.group_plan(qc, 4)[4])
        base = mq.smem_bytes(qc, 1, method="sum-product", schedule="layered")
        assert mq.smem_bytes(qc, 4, method="sum-product",
                             schedule="layered") == base + 4 * widest * qc.z
