"""The decode kernels' module on the CPU: its plain version against the
Pallas kernel itself (interpret mode), its plan table, and the kernels'
loops transliterated to NumPy over that plan.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what
they compute is checked here by running the loops of
csrc/minsum_qc.cu line for line in NumPy on the plan table the wrapper
hands them, against the plain version.
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
    # plan 13 + 3·86 + 25 = 296 ints, 86·81 message and 1944 posterior f32
    assert mq.smem_bytes(get_code("wifi1944").qc) == 4 * (296 + 86 * 81
                                                          + 1944)


def emulate_kernel(llr, qc, iterations, alpha, beta, clamp, layered):
    """csrc/minsum_qc.cu's decode loops in NumPy (float32 throughout),
    over the wrapper's plan and (α, β) table; returns the posterior in
    the log(Pr1/Pr0) convention."""
    f32 = np.float32
    row_ptr, col, shift, col_ptr, col_planes = unpack_plan(qc)
    ab = mq._ab_table(alpha, beta, iterations)
    z, mb, nb = qc.z, qc.mb, qc.nb
    B = llr.shape[0]
    msg = np.zeros((len(col), z, B), f32)
    post = (-llr.T).astype(f32)  # (n, B)
    lv = post.copy()
    clamp = f32(np.inf if clamp is None else clamp)

    def check_update(i, r, a, b):
        p0, p1 = row_ptr[i], row_ptr[i + 1]
        min1 = np.full(B, 1e30, f32)
        min2 = np.full(B, 1e30, f32)
        idx = np.full(B, -1)
        nneg = np.zeros(B, np.int64)
        for p in range(p0, p1):
            q = (r + shift[p]) % z
            v = post[col[p] * z + q] - msg[p, r]
            av = np.abs(v)
            nneg += v < 0
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
            exmin = np.where(idx == p, min2, min1)
            y = (sgn * np.maximum(exmin - f32(b), f32(0))) * f32(a)
            y = np.minimum(np.maximum(y, -clamp), clamp).astype(f32)
            msg[p, r] = y
            if layered:
                post[vi] = post[vi] + (y - old)

    for it in range(iterations):
        a, b = ab[it]
        if layered:
            for i in range(mb):
                for r in range(z):
                    check_update(i, r, a, b)
        else:
            for c in range(mb * z):
                check_update(c // z, c % z, a, b)
            for v in range(nb * z):
                j, q = divmod(v, z)
                acc = lv[v].copy()
                for e in range(col_ptr[j], col_ptr[j + 1]):
                    p = col_planes[e]
                    acc = acc + msg[p, (q - shift[p]) % z]
                post[v] = acc
    return -post.T


@pytest.mark.parametrize("kw", [
    dict(iterations=3, layered=False, alpha=1.0, beta=0.0, clamp=None),
    dict(iterations=3, layered=False, alpha=0.75, beta=0.1, clamp=2.0),
    dict(iterations=3, layered=True, alpha=A8[:3], beta=B8[:3],
         clamp=None),
], ids=["flooding", "flooding-a-b-clamp", "layered-tabled"])
def test_kernel_loops_match_plain_version(kw):
    qc = get_code("wifi648").qc
    llr = noisy_llrs(648, 4, seed=3)
    ours = emulate_kernel(llr, qc, **kw)
    layered = kw.pop("layered")
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior",
                      schedule="layered" if layered else "flooding",
                      **kw).numpy()
    np.testing.assert_array_equal(ours, ref)


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
    assert set(mq.LAUNCHES) == {"minsum_qc_flooding", "minsum_qc_layered"}
    mq.LAUNCHES["minsum_qc_layered"] += 3
    mq.reset_launch_counts()
    assert mq.LAUNCHES == {"minsum_qc_flooding": 0, "minsum_qc_layered": 0}
    # the plain version on the CPU is no launch
    mq.bp_qc_cuda(torch.zeros((2, 648)), get_code("wifi648").qc,
                  iterations=2)
    assert sum(mq.LAUNCHES.values()) == 0
