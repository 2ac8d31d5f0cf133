"""Sum-product flooding on the wide rows (the _lw kernels of
csrc/minsum_qc.cu) on the CPU: the codes beyond the narrow limits by their
row degree alone, here qc648_r56 and qc648_r34 (rows of degree 17-18 and
11-12, z = 27).

The CUDA kernels run only on the card (chip_smoke.py phase 2g holds each
of their 18 entry points to the plain version there); here their loop,
:func:`emulate_sumproduct_lw` (a check's slots two at a time, pass 1
writing each lt over the check's own message or into an f32 scratch and
its signs into one word, pass 2 reading them back), is held exactly to
the plain version in the fixed,
weighted, 4-bit quantized and early-stop forms at f32, bf16 and int8, and
to JAX's Pallas kernel in interpret mode. 32 codewords: every tensor a
multiple of 32 elements, so no CPU operation takes a scalar tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import init_neural_bp_weights
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll
from test_torch_kernels import (
    cached_code,
    emulate_sumproduct_lw,
    saturated_llrs,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
CODES = ("qc648_r56", "qc648_r34")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(llr, qc, **kw):
    return decode_roll(torch.from_numpy(llr), qc, method="sum-product",
                       schedule="flooding", **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("qbits", [None, 4], ids=["", "msgq4"])
@pytest.mark.parametrize("name", CODES)
def test_lt_wide_loop_matches_plain_version(name, qbits, dtype):
    """Fixed flooding-2 with and without 4-bit messages: every row but the
    conflicted saturated one exactly equal (both finite there: Σlt − lt
    cancels to a few ulps of one large lt), and the design the launcher
    takes."""
    code = cached_code(name)
    llr = saturated_llrs(code, 32, seed=61)
    kw = dict(iterations=2, msg_qbits=qbits, msg_qclip=20.0,
              dtype=DTYPES[dtype], clamp=20.0)
    ours = emulate_sumproduct_lw(llr, code, **kw)
    ref = plain(llr, code.qc, output="posterior", **kw).numpy()
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(ours[rows], ref[rows])
    assert mq.design(code.qc, "sum-product", "flooding") == "lt-wide"


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", CODES)
def test_lt_wide_weighted_loop_matches_plain_version(name, dtype):
    """The weighted loop (w·old in the v2c, the rebuild with the next
    row's weights) exactly equals decode_roll."""
    code = cached_code(name)
    llr = saturated_llrs(code, 32, seed=62)
    rng = np.random.default_rng(63)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in init_neural_bp_weights(code, 2).items()}
    kw = dict(iterations=2, weights=w, dtype=DTYPES[dtype])
    ours = emulate_sumproduct_lw(llr, code, **kw)
    ref = plain(llr, code.qc, output="posterior", **kw).numpy()
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(ours[rows], ref[rows])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 3])
def test_lt_wide_early_stop_matches_plain_version(K, dtype):
    """The _es forms on qc648_r56: the syndrome at entry and after every
    K-th of 3 iterations, each codeword frozen at its first satisfying
    state; bits and iterations exactly decode_roll's."""
    code = cached_code("qc648_r56")
    llr = saturated_llrs(code, 32, seed=64)
    kw = dict(iterations=3, dtype=DTYPES[dtype], clamp=20.0)
    bits, ran = emulate_sumproduct_lw(llr, code, early_stop_k=K, **kw)
    rb, ri = plain(llr, code.qc, output="hard_iters", early_stop=True,
                   es_check_every=K, **kw)
    rows = np.arange(32) != 1
    np.testing.assert_array_equal(bits[rows], rb.numpy()[rows])
    np.testing.assert_array_equal(ran, ri.numpy())
    # the rows span the regimes: some stop at entry, some later, some never
    assert (ran == 0).any() and (ran == 3).any()


def test_lt_wide_loop_matches_pallas_interpret():
    """The _lw loop on qc648_r34 (rows of degree 11-12) against JAX's
    Pallas kernel in interpret mode (one 128-lane tile), at the tolerance
    JAX holds that kernel to its roll backend: the TPU kernel takes
    log(1 − e^−a) as a series where the port calls expm1."""
    rng = np.random.default_rng(65)
    llr = rng.normal(0, 3, (128, 648)).astype(np.float32)
    kw = dict(iterations=2, clamp=20.0)
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr),
                                  jax_get_code("qc648_r34").qc,
                                  interpret=True, method="sum-product",
                                  schedule="flooding", output="posterior",
                                  **kw))
    ours = emulate_sumproduct_lw(llr, cached_code("qc648_r34"), **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["qc648_r56", "qc648_r34", "qc1944_r23"])
def test_lt_wide_cta_and_shared_memory(name):
    """The launcher's CTA: the lt-wide table's, 128 threads at bf16 and
    int8 on n = 1944 (not the launch table's wifi1944 int8 entry of the
    same n) and at f32 on n = 648, else 256; shared memory: the full
    messages, the posterior and the LLRs beside it (the lt values in the
    f32 messages or, at bf16 and int8, a local array); no plan (the
    parameter holds it)."""
    code = cached_code(name)
    qc = code.qc
    P, z, n = int(mq._plan_array(qc)[qc.mb]), qc.z, code.n

    def a16(x):
        return -(-x // 16) * 16

    for dt, (msg, post) in {"f32": (4, 4), "bf16": (2, 2),
                            "int8": (1, 4)}.items():
        want = 128 if (n, dt) in ((1944, "bf16"), (1944, "int8"),
                                  (648, "f32")) else 256
        assert mq.default_threads(qc, DTYPES[dt], "flooding",
                                  "sum-product") == want
        assert mq.smem_bytes(qc, 1, DTYPES[dt], "sum-product",
                             "flooding") == a16(msg * P * z) + 2 * a16(
                                 post * n)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_plain_fixed_is_the_plain_outputs(dtype):
    """chip_smoke.py's plain_fixed (phases 2f and 2g hold the kernels'
    posterior, hard_unsat and done_in outputs to one plain decode) equals
    the plain version's own ``hard_unsat`` output, and its rows equal a
    ``done_in`` decode's unskipped rows."""
    import chip_smoke

    code = cached_code("qc648_r56")
    llr = torch.from_numpy(saturated_llrs(code, 32, seed=66))
    kw = dict(iterations=2, method="sum-product", schedule="flooding",
              dtype=DTYPES[dtype], clamp=20.0)
    post, (bits, unsat) = chip_smoke.plain_fixed(llr, code.qc, **kw)
    rb, ru = decode_roll(llr, code.qc, output="hard_unsat", **kw)
    assert torch.equal(bits, rb) and torch.equal(unsat, ru)
    assert (ru > 0).any() and (ru == 0).any()
    skip = torch.arange(32) % 3 == 0
    ref = decode_roll(llr, code.qc, output="posterior", done_in=skip, **kw)
    assert torch.equal(post[~skip], ref[~skip])
