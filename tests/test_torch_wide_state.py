"""The compressed min-sum check state's wide word (the _cw kernels of
csrc/minsum_qc.cu) on the CPU: the codes whose rows exceed the narrow
word's 8 slots (qc648_r23, r34 and r56: rows of degree 8-9, 11-12 and
17-18, z = 27).

The CUDA kernels run only on the card (tests/test_torch_gpu.py); here
their serial-C and flooding loops, transliterated to NumPy in
tests/test_torch_kernels.py (:func:`emulate_flooding_cs`) with the 32-bit
word packed as the kernels pack it (24 sign bits, the slot of the first
minimum in bits 24-28, the flooding plan's entries carrying each slot's
sign bit and index field), are held exactly to the plain version and to
the Pallas kernel in interpret mode, and the launcher's choice of design,
its shared-memory sizes and the word's packing are pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
from ldpc_sims_tpu_torch.codes.library import QcStructure
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import init_neural_bp_weights
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan
from test_torch_group_serial import degree10_qc
from test_torch_kernels import (
    FLOODING_CS_CASES,
    bpsk_llrs,
    cached_code,
    emulate_kernel,
    flood_plan,
    integer_llrs,
)

WIDE = 24  # the wide word's sign bits (WIDE_LIMITS[0])
# the high-rate codes (n = 648 like wifi648) and the SNR at which the
# second of the early-stop cases' three channel codewords converges within
# 6 iterations (the first passes at entry at 12 dB, the third never at
# 2.5 dB)
CODES = {"qc648_r23": 5.5, "qc648_r34": 5.0, "qc648_r56": 5.5}
HIGH_RATE = ("qc648_r23", "qc648_r34", "qc648_r56", "qc1944_r23",
             "qc1944_r34", "qc1944_r56")


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(FLOODING_CS_CASES))
@pytest.mark.parametrize("name", list(CODES))
def test_wide_state_loops_match_plain_version(name, case, dtype, schedule):
    """The serial-C and flooding loops on the wide word (state → old
    messages → check pass → posterior) against the plain version at each
    storage type: the α/β table with a clamp and β above the minimum,
    3-bit messages, early stop at K = 1 and 2, per-edge weights.
    Posteriors and iteration counts exactly equal. Integer LLRs give ties,
    zero magnitudes and zero messages of both signs, on rows of up to 18
    slots (the first minimum at any of them)."""
    code = cached_code(name)
    kw = {"msg_qclip": 4.0, **FLOODING_CS_CASES[case]}
    weighted = kw.pop("weighted", False)
    K = kw.pop("check_every", 1)
    llr = integer_llrs(5, seed=31)
    if kw.get("early_stop"):
        llr = np.concatenate([llr[:2], np.stack([
            bpsk_llrs(12.0, seed=4), bpsk_llrs(CODES[name], seed=5),
            bpsk_llrs(2.5, seed=6)])])
    w = None
    if weighted:
        rng = np.random.default_rng(32)
        w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
             for k, v in init_neural_bp_weights(code, 2).items()}
    layered = schedule == "layered"
    ours, iters = emulate_kernel(llr, code.qc, layered=layered,
                                 compressed=True, dtype=dtype, weights=w,
                                 check_every=K, word_bits=WIDE, **kw)
    ref_kw = dict(kw, schedule=schedule, dtype=dtype, weights=w,
                  es_check_every=K)
    x = torch.from_numpy(llr)
    ref = decode_roll(x, code.qc, output="posterior", **ref_kw).numpy()
    np.testing.assert_array_equal(ours, ref)
    if kw.get("early_stop"):
        _, ref_iters = decode_roll(x, code.qc, output="hard_iters", **ref_kw)
        np.testing.assert_array_equal(iters, ref_iters.numpy())
        assert iters[-3] == 0 and iters[-1] == 6 and 0 < iters[-2] < 6
    assert mq.design(code.qc, "min-sum", schedule) == "compressed-wide"


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_wide_state_loop_matches_pallas_interpret(schedule):
    """Integer LLRs, α in {1, 0.5} and β in {0, 1}: every message and sum
    is exact, so the wide word's loops on qc648_r56 (rows of degree 17-18)
    equal JAX's Pallas kernel (interpret mode, one 128-lane tile)
    exactly."""
    llr = integer_llrs(128, seed=33)
    kw = dict(iterations=2, alpha=(1.0, 0.5), beta=(0.0, 1.0),
              schedule=schedule)
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr),
                                  jax_get_code("qc648_r56").qc,
                                  interpret=True, output="posterior", **kw))
    kw.pop("schedule")
    ours, _ = emulate_kernel(llr, cached_code("qc648_r56").qc, clamp=None,
                             layered=schedule == "layered", compressed=True,
                             word_bits=WIDE, **kw)
    np.testing.assert_array_equal(ours, ref)


def test_wide_word_packing():
    """The flooding plan's column entries on the wide word: each slot's
    sign bit (bits 0-23) and its index field (bits 24-28) are disjoint, so
    a degree-18 row's slot 17 reads back its own sign bit and slot; on the
    narrow word's packing (slot << 8) a slot of 8 or more would put its
    sign bit into the index field."""
    sign_mask, idx_mask = (1 << WIDE) - 1, 31 << WIDE
    assert mq.WIDE_LIMITS[0] == WIDE and max(mq.WIDE_LIMITS[1]) <= WIDE
    assert (WIDE - 1) << WIDE <= 0xFFFFFFFF  # the index field fits 32 bits
    for slot in range(WIDE):
        cz = (1 << slot) | (slot << WIDE)
        assert cz & sign_mask == 1 << slot and cz & idx_mask == slot << WIDE
        assert (cz & idx_mask) >> WIDE == slot
    narrow = (1 << 8) | (8 << 8)
    assert narrow & (7 << 8) != 0 and narrow & 0xFF == 0
    qc = cached_code("qc648_r56").qc
    row_ptr, plane, col_ptr, cols = flood_plan(qc, WIDE)
    assert max(np.diff(row_ptr)) == 18
    slots = plane[cols[:, 3], 3]
    assert 17 in slots
    np.testing.assert_array_equal(cols[:, 2] & sign_mask, 1 << slots)
    np.testing.assert_array_equal((cols[:, 2] & idx_mask) >> WIDE, slots)


@pytest.mark.parametrize("name", HIGH_RATE)
def test_wide_design_selection(name):
    """On the six codes beyond the narrow word by their row degree alone,
    min-sum flooding and serial-C (G = 1) take the wide word's _cw entry
    points at every storage type and form, sum-product serial-C the _rw
    entry points and the group-serial forms of both rules (G > 1) the _gw
    entry points; sum-product flooding alone keeps the full-message
    kernel."""
    qc = cached_code(name).qc
    assert not mq._within_limits(qc) and mq._within_limits(qc, wide=True)
    degrees = {len(ps) for ps in qc_plan(qc)[1]}
    assert degrees <= set(mq.WIDE_LIMITS[1]) and max(degrees) > 8
    for sched in ("flooding", "layered"):
        assert mq.design(qc, "min-sum", sched) == "compressed-wide"
        assert mq.compressed_state(qc, "min-sum", sched)
        sp = "_rw" if sched == "layered" else ""
        assert mq.design(qc, "sum-product", sched) == (
            "registers-wide" if sp else "full")
        for es, q, w in ((False, False, False), (True, True, False),
                         (False, True, True)):
            for dt, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16"),
                            (torch.int8, "_i8")):
                for rule, kind in (("min-sum", "_cw"), ("sum-product", sp)):
                    base = mq.kernel_name(rule, sched, es, q, w)
                    assert mq.entry_point(qc, rule, sched, es, q, w,
                                          dt) == base + kind + sfx
    for G in (2, 4, qc.mb):
        assert mq.design(qc, "min-sum", "layered", G) == "group-wide"
        assert mq.design(qc, "sum-product", "layered", G) == "group-wide"
        assert mq.compressed_state(qc, "min-sum", "layered", G)
        assert mq.sumproduct_registers(qc, "sum-product", "layered", G)
    # G above mb is taken as mb; a one-row code's G is 1
    assert mq.design(qc, "min-sum", "layered", 1) == "compressed-wide"


def test_wide_design_needs_a_body_of_each_degree():
    """A code within the limits but for a row of a degree the wide kernels
    have no body for (10) keeps the full messages in every form of both
    rules, at z = 4 and on qc1944_r34's base with one circulant dropped
    (z = 81); the codes within the narrow word keep its _cs kernels."""
    row = (0,) * 10 + (-1,) * 2
    for qc in (QcStructure(z=4, base=(row, row[::-1])), degree10_qc()):
        assert 10 in {len(ps) for ps in qc_plan(qc)[1]}
        assert 10 not in mq.WIDE_LIMITS[1]
        for rule in ("min-sum", "sum-product"):
            for sched, G in (("flooding", 1), ("layered", 1),
                             ("layered", 2), ("layered", qc.mb)):
                assert mq.design(qc, rule, sched, G) == "full"
                assert mq.entry_point(qc, rule, sched, dtype=torch.int8,
                                      layered_group=G) == (
                    mq.kernel_name(rule, sched) + "_i8")
    w648 = cached_code("wifi648").qc
    assert mq.design(w648, "min-sum", "flooding") == "compressed"
    assert mq.entry_point(w648, "min-sum", "layered", True) == \
        "minsum_qc_layered_es_cs"


def test_smem_bytes_wide_state():
    """The wide word takes 4 B a check (the narrow word 2): qc1944_r56 has
    4 × 81 = 324 checks, two stored magnitudes each (8, 4 or 2 B at f32,
    bf16, int8), 1,296 B of words and the 1,944-variable posterior;
    serial-C adds the plan (5 + 3·69 + 25 = 237 ints, 960 B padded),
    flooding the LLRs instead (the parameter holds its plan)."""
    qc = cached_code("qc1944_r56").qc
    ms = dict(method="min-sum", schedule="layered")
    fl = dict(method="min-sum", schedule="flooding")
    assert mq.smem_bytes(qc, 1, **ms) == 960 + 2592 + 1296 + 7776
    assert mq.smem_bytes(qc, 1, **fl) == 2592 + 1296 + 2 * 7776
    assert mq.smem_bytes(qc, 1, torch.bfloat16, **ms) == (960 + 1296 + 1296
                                                          + 3888)
    assert mq.smem_bytes(qc, 1, torch.int8, **fl) == 656 + 1296 + 2 * 7776
    # the full messages of its sum-product forms: 69 planes, with their
    # plan in the kernel parameter (the _rw kernels)
    sp = mq.smem_bytes(qc, 1, method="sum-product", schedule="layered")
    assert sp == 22_368 + 7776  # 22,356 B of messages, aligned
    # the full-message kernels on a code with a row of degree 10 keep the
    # plan (7 + 3·66 + 25 = 230 ints, 928 B padded) in shared memory
    d10 = degree10_qc()
    assert mq.smem_bytes(d10, 1, method="sum-product",
                         schedule="layered") == 928 + 21_392 + 7776
