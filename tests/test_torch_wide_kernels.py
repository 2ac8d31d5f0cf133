"""The group-serial forms of both rules and sum-product's flooding and
serial-C forms on the wide rows (the _gw and _rw kernels of
csrc/minsum_qc.cu) on the CPU: the codes beyond the narrow limits by their
row degree alone (qc648_r23, r34 and r56: rows of degree 8-9, 11-12 and
17-18, z = 27; the qc1944 codes of the same bases, z = 81, in the pins).

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py phases 2f and 2g); here their loops, transliterated to torch
in tests/test_torch_group_serial.py (:func:`emulate_group_serial`, with
min-sum's word the wide one) and tests/test_torch_kernels.py
(:func:`emulate_sumproduct_sr`, each row's slots unrolled to its degree),
are held exactly to the plain version at f32, bf16 and int8, at G = 2, 4
and mb, with early stop, per-edge weights and message quantization, and
one case of each to JAX's Pallas kernel in interpret mode. The launcher's
design, entry points and shared-memory sizes are pinned on all six codes.
32 codewords: every tensor a multiple of 32 elements, so no CPU operation
takes a scalar tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import init_neural_bp_weights
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan
from test_torch_group_serial import (
    RULES,
    cached_code,
    emulate_group_serial,
    integer_llrs,
    regimes_llrs,
    saturated_llrs,
)
from test_torch_kernels import emulate_sumproduct_sr

WIDE = mq.WIDE_LIMITS[0]  # the wide word's sign bits
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
HIGH_RATE = ("qc648_r23", "qc648_r34", "qc648_r56", "qc1944_r23",
             "qc1944_r34", "qc1944_r56")
# G = 2, 4 and mb on each qc648 code (mb: 8, 6 and 4 block rows)
GROUPS = [("qc648_r23", 2), ("qc648_r23", 4), ("qc648_r23", 8),
          ("qc648_r34", 2), ("qc648_r34", 4), ("qc648_r34", 6),
          ("qc648_r56", 2), ("qc648_r56", 4)]
SIZES = {"f32": (4, 4), "bf16": (2, 2), "int8": (1, 4)}  # message, posterior


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def llrs_for(rule, code, seed):
    """Saturated channel LLRs for sum-product, integer LLRs for min-sum."""
    return (saturated_llrs(code, 32, seed) if rule == "sum-product"
            else integer_llrs(code, 32, seed))


def held_to_plain(llr, qc, G, kw, sum_product):
    """The _gw loop against decode_roll(layered_group=G), exactly (the
    conflicted saturated row of a sum-product input to finiteness: there
    Σlt − lt cancels to a few ulps of one large lt)."""
    ours, _ = emulate_group_serial(llr, qc, G, word_bits=WIDE, **kw)
    ref = decode_roll(torch.from_numpy(llr), qc, output="posterior",
                      schedule="layered", layered_group=G, **kw).numpy()
    rows = np.arange(llr.shape[0]) != (1 if sum_product else -1)
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_array_equal(ours[rows], ref[rows])


@pytest.mark.parametrize("name, G", GROUPS, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_wide_group_serial_loop_matches_plain_version(rule, dtype, name, G):
    """The _gw loop at each storage type, with and without 3-bit messages:
    min-sum on integer LLRs (ties, zero magnitudes, the first minimum at
    any of up to 18 slots) with the α/β table, a clamp and β above the
    minimum, on the wide word; sum-product on saturated channel LLRs.
    Posteriors exactly equal to decode_roll(layered_group=G)."""
    code = cached_code(name)
    assert G in (2, 4, code.qc.mb)
    sp = rule == "sum-product"
    llr = llrs_for(rule, code, seed=41)
    for qbits in (None, 3):
        kw = dict(RULES[rule], iterations=3, dtype=DTYPES[dtype],
                  msg_qbits=qbits, msg_qclip=4.0 if not sp else 20.0)
        held_to_plain(llr, code.qc, G, kw, sp)
    assert mq.design(code.qc, rule, "layered", G) == "group-wide"


@pytest.mark.parametrize("name", HIGH_RATE[:3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_wide_group_serial_weighted_loop(rule, dtype, name):
    """Per-edge weights at G = 2 with 4-bit messages: w·old in the v2c,
    w·(new − old) to the posterior or the scratch, the re-base with the
    next row's weights (min-sum's rebuilt from the wide word); exactly
    equal."""
    code = cached_code(name)
    sp = rule == "sum-product"
    llr = saturated_llrs(code, 32, seed=42)
    rng = np.random.default_rng(43)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in init_neural_bp_weights(code, 2).items()}
    kw = dict(RULES[rule], iterations=2, dtype=DTYPES[dtype], weights=w,
              msg_qbits=4, msg_qclip=20.0)
    if not sp:
        kw.update(alpha=0.75, beta=(0.0, 1.0))
    held_to_plain(llr, code.qc, 2, kw, sp)


@pytest.mark.parametrize("name", HIGH_RATE[:3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rule", list(RULES))
def test_wide_group_serial_early_stop_loop(rule, dtype, name):
    """Early stop at K = 2 under G = 4: posteriors and iteration counts
    exactly equal; codewords pass at entry and others never do."""
    code = cached_code(name)
    llr = regimes_llrs(code, 32, seed=44)
    kw = dict(RULES[rule], iterations=6, dtype=DTYPES[dtype], msg_qclip=20.0)
    if rule == "min-sum":
        kw.update(alpha=0.8, beta=0.05, clamp=None)
    ours, iters = emulate_group_serial(llr, code.qc, 4, early_stop=True,
                                       check_every=2, word_bits=WIDE, **kw)
    x = torch.from_numpy(llr)
    ref_kw = dict(kw, schedule="layered", layered_group=4, early_stop=True,
                  es_check_every=2)
    ref = decode_roll(x, code.qc, output="posterior", **ref_kw).numpy()
    _, ref_iters = decode_roll(x, code.qc, output="hard_iters", **ref_kw)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(iters, ref_iters.numpy())
    assert iters.min() == 0 and iters.max() == 6


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", HIGH_RATE[:3])
def test_wide_sumproduct_registers_loop(name, dtype):
    """The serial-C _rw loop (each row's 8-18 slots unrolled, the row
    summed left to right, pass 2 from registers and the slot's message and
    posterior read again) equals decode_roll's sum-product exactly on
    every row but the conflicted saturated one, with and without 5-bit
    messages."""
    code = cached_code(name)
    llr = saturated_llrs(code, 32, seed=45)
    for qbits in (None, 5):
        kw = dict(iterations=2, msg_qbits=qbits, msg_qclip=20.0,
                  dtype=DTYPES[dtype], clamp=20.0)
        ours = emulate_sumproduct_sr(llr, code.qc, layered=True, **kw)
        ref = decode_roll(torch.from_numpy(llr), code.qc,
                          output="posterior", method="sum-product",
                          schedule="layered", **kw).numpy()
        assert np.isfinite(ours).all() and np.isfinite(ref).all()
        rows = np.arange(32) != 1
        np.testing.assert_array_equal(ours[rows], ref[rows])
    assert mq.design(code.qc, "sum-product", "layered") == "registers-wide"


@pytest.mark.parametrize("name", HIGH_RATE[:3])
def test_wide_sumproduct_registers_weighted_loop(name):
    """The weighted serial-C _rw loop (w·old in the v2c, w·(new − old)
    folded, the re-base with the next row's weights) exactly equals
    decode_roll."""
    code = cached_code(name)
    llr = saturated_llrs(code, 32, seed=46)
    rng = np.random.default_rng(47)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in init_neural_bp_weights(code, 2).items()}
    ours = emulate_sumproduct_sr(llr, code.qc, 2, True, weights=w)
    ref = decode_roll(torch.from_numpy(llr), code.qc, iterations=2,
                      output="posterior", method="sum-product", weights=w,
                      schedule="layered").numpy()
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(ours[rows], ref[rows])


def test_wide_group_serial_loop_matches_pallas_interpret():
    """Integer LLRs, α in {1, 0.5} and β in {0, 1}: every message and sum
    is exact, so the _gw min-sum loop on qc648_r56 (rows of degree 17-18)
    at G = 2 equals JAX's Pallas kernel (interpret mode, one 128-lane
    tile) exactly."""
    rng = np.random.default_rng(48)
    llr = rng.integers(-3, 4, (128, 648)).astype(np.float32)
    kw = dict(iterations=2, alpha=(1.0, 0.5), beta=(0.0, 1.0))
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr),
                                  jax_get_code("qc648_r56").qc,
                                  interpret=True, output="posterior",
                                  schedule="layered", layered_group=2, **kw))
    ours, _ = emulate_group_serial(llr, cached_code("qc648_r56").qc, 2,
                                   word_bits=WIDE, **kw)
    np.testing.assert_array_equal(ours, ref)


def test_wide_sumproduct_registers_loop_matches_pallas_interpret():
    """The layered _rw loop on qc648_r34 (rows of degree 11-12) against
    JAX's Pallas kernel in interpret mode, at the tolerance JAX holds that
    kernel to its roll backend (the TPU kernel takes log(1 − e^−a) as a
    series where the port calls expm1)."""
    rng = np.random.default_rng(49)
    llr = rng.normal(0, 3, (128, 648)).astype(np.float32)
    kw = dict(iterations=2, clamp=20.0)
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr),
                                  jax_get_code("qc648_r34").qc,
                                  interpret=True, method="sum-product",
                                  schedule="layered", output="posterior",
                                  **kw))
    ours = emulate_sumproduct_sr(llr, cached_code("qc648_r34").qc,
                                 layered=True, **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", HIGH_RATE)
def test_wide_kernel_pins(name):
    """On each of the six codes, every form of both rules but sum-product
    flooding takes a design of the wide rows: min-sum flooding and
    serial-C the _cw kernels, sum-product serial-C the _rw kernels, the
    group-serial forms of both rules (G = 2, 3, 4, mb) the _gw kernels, at
    every storage type; sum-product flooding keeps the full-message
    kernel. Their shared memory: the full messages (sum-product) or the
    wide word's state (min-sum: two stored magnitudes and a 4-byte word a
    check), the posterior, for min-sum flooding the LLRs beside it, for
    G > 1 the largest group's shared planes of f32 scratch; a plan for
    min-sum serial-C and the full-message kernel (the parameter holds the
    others')."""
    qc = cached_code(name).qc
    planes, group_c, _ = qc_plan(qc)
    P, z, mb, n = len(planes), qc.z, qc.mb, qc.nb * qc.z
    assert not mq._within_limits(qc) and mq._within_limits(qc, wide=True)

    def a16(x):
        return -(-x // 16) * 16

    # the serial-C min-sum forms' plan in shared memory (its weighted
    # re-base reads the columns from it)
    plan = a16(4 * (mb + 1 + 3 * P + qc.nb + 1))

    for rule in ("min-sum", "sum-product"):
        for sched, G in (("flooding", 1), ("layered", 1), ("layered", 2),
                         ("layered", 3), ("layered", 4), ("layered", mb)):
            kind = mq.design(qc, rule, sched, G)
            full = rule == "sum-product" and sched == "flooding"
            want = ("full" if full else "group-wide" if G > 1
                    else "compressed-wide" if rule == "min-sum"
                    else "registers-wide")
            assert kind == want
            assert mq.compressed_state(qc, rule, sched, G) == (
                rule == "min-sum")
            assert mq.sumproduct_registers(qc, rule, sched, G) == (
                rule == "sum-product" and not full)
            for es, q, w in ((False, False, False), (True, False, False),
                             (False, True, False), (True, True, False),
                             (False, False, True), (False, True, True)):
                if es and w:
                    continue
                for dt, sfx in (("f32", ""), ("bf16", "_bf16"),
                                ("int8", "_i8")):
                    assert mq.entry_point(qc, rule, sched, es, q, w,
                                          DTYPES[dt], G) == (
                        mq.kernel_name(rule, sched, es, q, w)
                        + mq.DESIGNS[want][1] + sfx)
                    msg, post = SIZES[dt]
                    state = (a16(2 * msg * mb * z) + a16(4 * mb * z)
                             if rule == "min-sum" else a16(msg * P * z))
                    posts = (2 if sched == "flooding" and not full else 1) \
                        * a16(post * n)
                    scratch = (4 * int(mq.group_plan(qc, G)[4]) * z
                               if G > 1 else 0)
                    with_plan = full or (kind == "compressed-wide"
                                         and sched == "layered")
                    assert mq.smem_bytes(qc, G, DTYPES[dt], rule, sched) \
                        == plan * with_plan + state + posts + scratch
    assert {len(ps) for ps in group_c} <= set(mq.WIDE_LIMITS[1])


def test_wide_smem_bytes_qc1944_r34():
    """qc1944_r34 (6 × 24 circulants, 67 planes, z = 81) at f32: min-sum
    G = 4 on the wide word 5,840 B of state (5,832 aligned), 7,776 B of
    posterior and 35 shared planes of scratch (11,340 B); sum-product's
    21,708 B of messages (21,712 aligned) serial-C, and with G = 4's
    scratch; its flooding on the full-message kernel with the plan (7 +
    3·67 + 25 = 233 ints, 944 B padded) and no LLRs."""
    qc = cached_code("qc1944_r34").qc
    scratch = 4 * 35 * 81
    assert int(mq.group_plan(qc, 4)[4]) == 35
    assert mq.smem_bytes(qc, 4, method="min-sum", schedule="layered") == \
        5840 + 7776 + scratch
    assert mq.smem_bytes(qc, 1, method="sum-product",
                         schedule="layered") == 21_712 + 7776
    assert mq.smem_bytes(qc, 1, method="sum-product",
                         schedule="flooding") == 944 + 21_712 + 7776
    assert mq.smem_bytes(qc, 4, method="sum-product", schedule="layered") \
        == 21_712 + 7776 + scratch
