"""The decode kernels' module on the CPU: its plain version against the
Pallas kernel itself (interpret mode), its plan table, and the kernels'
loops transliterated to NumPy over that plan.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what
they compute is checked here by running the loops of
csrc/minsum_qc.cu line for line in NumPy on the plan table the wrapper
hands them, fixed and early-stop forms, min-sum and sum-product, with and
without message quantization, against the plain version. Min-sum, with
or without quantization, agrees exactly. Sum-product agrees within 1e-5
(absolute and relative): NumPy's float32 exp/expm1/log1p/log round
differently from PyTorch's on the CPU, and PyTorch's own CPU log1p
differs in the last bit between vector lanes and scalar tails; on the
card both sides call the same libdevice functions (tests/test_torch_gpu.py
asks for equality of bits there).
"""

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
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan

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
                   msg_qbits=None, msg_qclip=20.0):
    """The kernels' decode for a (B, n) LLR batch; returns the posterior
    in the log(Pr1/Pr0) convention and the (B,) iterations each codeword
    ran (``iterations`` for the fixed forms). Each codeword is one CTA:
    under early stop it votes on its syndrome at entry and after every
    ``check_every``-th iteration and leaves the loop when it holds."""
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
    # plan 13 + 3·86 + 25 = 296 ints, 86·81 message and 1944 posterior f32,
    # each region on a 16-byte boundary (the messages' 27,864 B take 27,872)
    assert mq.smem_bytes(get_code("wifi1944").qc) == 4 * 296 + 27_872 + \
        4 * 1944


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
