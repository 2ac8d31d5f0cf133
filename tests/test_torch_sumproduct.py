"""The port's sum-product decode (plain version, CPU) against JAX's roll decode.

Same numpy LLRs into both packages, wifi648 and wifi1944, both schedules:
posteriors within rtol = atol = 1e-4 (the tolerance of
tests/test_torch_decode.py; JAX holds its Pallas kernel to the roll
backend within 1e-3), hard bits equal wherever the JAX posterior is
farther than 1e-3 from 0, early-stop iteration counts equal. The two
differ in float rounding only: XLA's exp and log on the CPU are its own
approximations, and it sums Σlt in its own order where the port sums
left to right.

Every case carries a codeword saturated at |LLR| = 60, which must decode
to finite posteriors (the JAX package records NaN cascades of saturated
sum-product messages on the TPU). A second saturated row with random
signs, all checks in conflict, is held only to finiteness: there
Σlt − lt cancels to a few ulps of one large lt, so last-bit differences
of the two libraries move a message by up to its bound of 28.3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import bp_decode

CODES = ["wifi648", "wifi1944"]
SP = dict(method="sum-product", clamp=None)


def llrs_with_saturation(code, batch, mu, seed=0):
    """Consistent-Gaussian LLRs (mean ±mu, variance 2mu), log(Pr1/Pr0),
    of random codewords; row 0 is its codeword at ±60, row 1 ±60 with
    random signs. Returns (llr, codewords)."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, np.sqrt(2 * mu), cw.shape)
    llr[0] = (2.0 * cw[0] - 1.0) * 60.0
    llr[1] = np.where(rng.random(code.n) < 0.5, -60.0, 60.0)
    return np.ascontiguousarray(llr, np.float32), cw


def awgn_llrs(n, batch, snrdb, seed=0):
    """BPSK all-zero codeword over AWGN at ``snrdb``: log(Pr1/Pr0)."""
    rng = np.random.default_rng(seed)
    sigma = 10 ** (-snrdb / 20.0)
    r = 1.0 + sigma * rng.normal(0, 1, (batch, n))
    return (-2.0 * r / (sigma * sigma)).astype(np.float32)


def jax_decode(llr, name, **kw):
    out = jax_bp_decode(jnp.asarray(llr), jax_get_code(name), backend="roll",
                        **kw)
    return tuple(map(np.asarray, out)) if isinstance(out, tuple) \
        else np.asarray(out)


def sure(ref):
    return np.abs(ref) > 1e-3


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", CODES)
def test_sumproduct_matches_jax_roll(name, schedule):
    llr, cw = llrs_with_saturation(jax_get_code(name), 16, 2.0)
    kw = dict(iterations=5, schedule=schedule, **SP)
    ref = jax_decode(llr, name, output="posterior", **kw)
    post = bp_decode(torch.from_numpy(llr), get_code(name),
                     output="posterior", **kw).numpy()
    assert np.isfinite(post).all() and np.isfinite(ref).all()
    rows = np.arange(16) != 1  # the conflicted row: finite only
    np.testing.assert_allclose(post[rows], ref[rows], rtol=1e-4, atol=1e-4)
    ok = sure(ref) & rows[:, None]
    np.testing.assert_array_equal((post > 0)[ok], (ref > 0)[ok])
    np.testing.assert_array_equal(post[0] > 0, cw[0] == 1)
    # the sum-product magnitude bound: |post| <= |LLR| + 28.3 per edge
    assert np.abs(post[0]).min() > 60.0
    bits = bp_decode(torch.from_numpy(llr), get_code(name), **kw)
    assert bits.dtype == torch.int8
    np.testing.assert_array_equal(bits.numpy(), post > 0)


@pytest.mark.parametrize("name, schedule, snrdb", [
    ("wifi648", "layered", 1.5), ("wifi1944", "flooding", 2.5)])
def test_sumproduct_freeze_matches_jax_roll(name, schedule, snrdb):
    """Per-codeword freeze: iteration counts exactly equal, hard bits
    equal where the posterior is sure; row 0 is the all-zero codeword at
    |LLR| = 60, which passes at entry."""
    code = get_code(name)
    llr = awgn_llrs(code.n, 48, snrdb, seed=1)
    llr[0] = -60.0
    kw = dict(iterations=6, early_stop=True, schedule=schedule, **SP)
    jbits, jiters = jax_decode(llr, name, output="hard_iters", **kw)
    post = bp_decode(torch.from_numpy(llr), code, backend="roll",
                     output="posterior", **kw).numpy()
    _, iters = bp_decode(torch.from_numpy(llr), code, backend="roll",
                         output="hard_iters", **kw)
    assert np.isfinite(post).all()
    np.testing.assert_array_equal(iters.numpy(), jiters)
    assert iters[0] == 0 and (iters < 6).any() and (iters == 6).any()
    ok = sure(post)
    np.testing.assert_array_equal((post > 0)[ok], jbits[ok] == 1)


@pytest.mark.parametrize("name", CODES)
def test_sumproduct_hard_unsat_and_done_in_match_jax_roll(name):
    """The kernels' fused count and skip forms, held to JAX's roll decode
    of the same rows: bits equal where sure, counts equal to the
    syndrome weight of the bits, skipped rows left as they were."""
    code = get_code(name)
    llr = awgn_llrs(code.n, 32, 2.0, seed=2)
    llr[0] = -60.0
    kw = dict(iterations=4, schedule="layered", **SP)
    jpost = jax_decode(llr, name, output="posterior", **kw)
    ok = sure(jpost)
    bits, unsat = mq.bp_qc_cuda(torch.from_numpy(llr), code.qc,
                                output="hard_unsat", **kw)
    np.testing.assert_array_equal(bits.numpy()[ok], (jpost > 0)[ok])
    H = code.H.astype(np.int64)
    np.testing.assert_array_equal(
        unsat.numpy(), ((bits.numpy().astype(np.int64) @ H.T) % 2).sum(1))
    assert unsat[0] == 0 and (unsat > 0).any()
    done = torch.arange(32) % 3 == 0
    out = torch.full(llr.shape, 7, dtype=torch.int8)
    mq.bp_qc_cuda(torch.from_numpy(llr), code.qc, done_in=done, out=out,
                  **kw)
    assert (out[done] == 7).all()
    keep = ok & ~done.numpy()[:, None]
    np.testing.assert_array_equal(out.numpy()[keep], (jpost > 0)[keep])


def test_sumproduct_drivers_match_their_passes():
    """es_mode 'requeue' with sum-product: bits and counts those of the
    JAX roll decodes that make up its passes; es_mode 'probe': those of
    its passes in the plain version."""
    name = "wifi648"
    code = get_code(name)
    llr = awgn_llrs(code.n, 32, 3.5, seed=3)
    llr[0] = -60.0
    x = torch.from_numpy(llr)
    kw = dict(iterations=6, schedule="layered", early_stop=True,
              es_probe_iters=2, output="hard_iters", backend="cuda", **SP)
    # requeue: an early-stop probe of 2, then early stop at the budget
    bits, iters = bp_decode(x, code, es_mode="requeue", **kw)
    es = dict(schedule="layered", early_stop=True, output="hard_iters", **SP)
    b1, i1 = jax_decode(llr, name, iterations=2, **es)
    b2, i2 = jax_decode(llr, name, iterations=6, **es)
    done = i1 < 2
    assert done.any() and not done.all()
    np.testing.assert_array_equal(iters.numpy(),
                                  np.where(done, i1, 2 + i2))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.where(done[:, None], b1, b2))
    # probe: a fixed probe of 2, then a fixed budget for what fails it
    bits, iters = bp_decode(x, code, es_mode="probe", **kw)
    fixed = dict(schedule="layered", **SP)
    b1, unsat = mq.bp_qc_cuda(x, code.qc, 2, output="hard_unsat", **fixed)
    b2 = mq.bp_qc_cuda(x, code.qc, 6, **fixed)
    done = unsat == 0
    assert done.any() and not done.all()
    assert torch.equal(bits, torch.where(done[:, None], b1, b2))
    assert torch.equal(iters, torch.where(done, 2, 8).to(torch.int32))


def test_sumproduct_rejects_tabled_alpha_beta():
    """Per-iteration α/β are a min-sum schedule: both packages refuse
    them with sum-product, and ignore scalar ones."""
    name = "wifi648"
    llr = awgn_llrs(648, 4, 2.0)
    for decode, arg in ((jax_bp_decode, jnp.asarray(llr)),
                        (bp_decode, torch.from_numpy(llr))):
        code = (jax_get_code if decode is jax_bp_decode else get_code)(name)
        with pytest.raises(ValueError, match="require method='min-sum'"):
            decode(arg, code, iterations=2, method="sum-product",
                   alpha=(0.8, 0.9))
    plain = bp_decode(torch.from_numpy(llr), get_code(name), iterations=2,
                      output="posterior", **SP)
    scaled = bp_decode(torch.from_numpy(llr), get_code(name), iterations=2,
                       output="posterior", alpha=0.5, beta=0.3, **SP)
    assert torch.equal(plain, scaled)
    with pytest.raises(ValueError, match="require min-sum"):
        mq.bp_qc_cuda(torch.from_numpy(llr), get_code(name).qc, 2,
                      alpha=(0.8, 0.9), method="sum-product")
