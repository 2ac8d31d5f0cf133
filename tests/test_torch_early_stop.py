"""The port's early-stop decode (plain version, CPU) against the JAX package.

Same numpy LLRs into both packages, wifi648, batch 128:

* per-codeword freeze against JAX ``bp_decode(early_stop=True,
  backend='roll')``, both schedules: iteration counts exactly equal, hard
  bits equal wherever the JAX posterior is farther than 1e-3 from 0 (the
  tolerance of tests/test_torch_decode.py). The flooding case runs at an
  SNR where codewords converge, since the two flooding updates differ in
  the last bit of their sums (tests/test_torch_decode.py's docstring);
* the check stride ``es_check_every`` and the fused unsatisfied-check
  count against ``bp_qc_pallas`` itself in interpret mode: bits and
  counts exactly equal;
* the ``done_in`` skip and the argument errors of the JAX functions.

The drivers (requeue, probe) are in tests/test_torch_es_drivers.py; the
CUDA kernels' early-stop loop, transliterated to NumPy, is held against
the plain version in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import bp_decode
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, unsat_checks

NAME = "wifi648"


def awgn_llrs(n, batch, snrdb, seed=0):
    """BPSK all-zero codeword over AWGN at ``snrdb``: log(Pr1/Pr0)."""
    rng = np.random.default_rng(seed)
    snr = 10 ** (snrdb / 10.0)
    sigma = (1 / snr) ** 0.5
    r = 1.0 + sigma * rng.normal(0, 1, (batch, n))
    return (-2.0 * r / (sigma * sigma)).astype(np.float32)


@pytest.mark.parametrize("schedule, snrdb", [("flooding", 2.5),
                                             ("layered", 1.5)])
def test_freeze_matches_jax_roll(schedule, snrdb):
    llr = awgn_llrs(648, 128, snrdb)
    kw = dict(iterations=20, method="min-sum", early_stop=True,
              schedule=schedule)
    jcode = jax_get_code(NAME)
    jbits, jiters = jax_bp_decode(jnp.asarray(llr), jcode, backend="roll",
                                  output="hard_iters", **kw)
    jpost = np.asarray(jax_bp_decode(jnp.asarray(llr), jcode,
                                     backend="roll", output="posterior",
                                     **kw))
    bits, iters = bp_decode(torch.from_numpy(llr), get_code(NAME),
                            backend="roll", output="hard_iters", **kw)
    assert iters.dtype == torch.int32
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    # both populations: converged early and run to the budget
    assert (iters < 20).any() and (iters == 20).any()
    sure = np.abs(jpost) > 1e-3
    np.testing.assert_array_equal(bits.numpy()[sure],
                                  np.asarray(jbits)[sure])


def test_check_stride_matches_pallas():
    """es_check_every=3: checks after iterations 3, 6, ...; counts are
    multiples of K and equal the Pallas kernel's."""
    code = jax_get_code(NAME)
    llr = awgn_llrs(648, 128, 2.0, seed=1)
    kw = dict(iterations=12, early_stop=True, es_check_every=3,
              schedule="layered", output="hard_iters")
    jbits, jiters = bp_qc_pallas(jnp.asarray(llr), code.qc, interpret=True,
                                 **kw)
    bits, iters = mq.bp_qc_cuda(torch.from_numpy(llr), get_code(NAME).qc,
                                **kw)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert set(iters.tolist()) >= {6, 12} and not (iters % 3).any()


def test_hard_unsat_matches_pallas():
    code = jax_get_code(NAME)
    llr = awgn_llrs(648, 128, 2.0, seed=2)
    kw = dict(iterations=4, schedule="layered", output="hard_unsat")
    jbits, junsat = bp_qc_pallas(jnp.asarray(llr), code.qc, interpret=True,
                                 **kw)
    bits, unsat = mq.bp_qc_cuda(torch.from_numpy(llr), get_code(NAME).qc,
                                **kw)
    assert unsat.dtype == torch.int32
    np.testing.assert_array_equal(unsat.numpy(), np.asarray(junsat))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    # the count is the syndrome weight of the returned bits
    H = get_code(NAME).H.astype(np.int64)
    np.testing.assert_array_equal(
        unsat.numpy(), ((bits.numpy().astype(np.int64) @ H.T) % 2).sum(1))
    assert (unsat == 0).any() and (unsat > 0).any()


def test_done_in_skips_codewords():
    """done_in: flagged codewords are not decoded and report 0 iterations;
    the others skip the entry check and decode as they would alone."""
    qc = get_code(NAME).qc
    llr = torch.from_numpy(awgn_llrs(648, 16, 2.0, seed=7))
    done = torch.arange(16) % 4 == 0
    kw = dict(iterations=10, schedule="layered", early_stop=True,
              output="hard_iters")
    bits, iters = decode_roll(llr, qc, done_in=done, **kw)
    alone_bits, alone_iters = decode_roll(llr[~done], qc, **kw)
    assert (iters[done] == 0).all()
    assert torch.equal(iters[~done], alone_iters)
    assert torch.equal(bits[~done], alone_bits)
    # the wrapper writes only the rows it decodes into a given buffer
    out = torch.full(llr.shape, 7, dtype=torch.int8)
    got, _ = mq.bp_qc_cuda(llr, qc, done_in=done, out=out, **kw)
    assert got is out and (out[done] == 7).all()
    assert torch.equal(out[~done], alone_bits)


def test_unsat_checks_is_the_syndrome_weight():
    code = get_code(NAME)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (5, 648))
    post = torch.from_numpy(np.where(bits == 1, -1.0, 1.0).astype(
        np.float32)).reshape(5, code.qc.nb, code.qc.z)
    np.testing.assert_array_equal(
        unsat_checks(post, code.qc).numpy(),
        ((bits @ code.H.T.astype(np.int64)) % 2).sum(1))


@pytest.mark.parametrize("call, exc, match", [
    (lambda z, c: mq.bp_qc_cuda(z, c.qc, iterations=10, early_stop=True,
                                es_check_every=3), ValueError,
     "must divide"),
    (lambda z, c: mq.bp_qc_cuda(z, c.qc, iterations=4, early_stop=True,
                                output="hard_unsat"), ValueError,
     "hard_unsat"),
    (lambda z, c: mq.bp_qc_cuda(z, c.qc, iterations=4,
                                output="hard_iters"), ValueError,
     "requires early_stop"),
    (lambda z, c: mq.bp_qc_requeue(z, c.qc, iterations=10,
                                   output="posterior"), ValueError,
     "hard bits only"),
    (lambda z, c: mq.bp_qc_probe_requeue(z, c.qc, iterations=10,
                                         output="posterior"), ValueError,
     "hard bits only"),
    (lambda z, c: bp_decode(z, c, iterations=10, early_stop=True,
                            es_mode="requeue", backend="roll"), ValueError,
     "cuda-only"),
    (lambda z, c: bp_decode(z, c, iterations=10, early_stop=True,
                            es_check_every=2, backend="roll"), ValueError,
     "cuda-only"),
    (lambda z, c: bp_decode(z, c, iterations=10, early_stop=True,
                            es_mode="requeue", output="posterior"),
     ValueError, "hard"),
    (lambda z, c: bp_decode(z, c, iterations=8, schedule="layered",
                            early_stop=True, es_mode="probe",
                            es_check_every=2), ValueError,
     "no effect under es_mode"),
    (lambda z, c: bp_decode(z, c, iterations=8, early_stop=True,
                            weights={"w_msg": 1}), ValueError,
     "early_stop with neural-BP weights"),
], ids=["stride-divides", "unsat-without-es", "iters-needs-es",
        "requeue-hard-only", "probe-hard-only", "requeue-cuda-only",
        "stride-cuda-only", "requeue-output", "probe-stride",
        "es-weights"])
def test_early_stop_argument_errors(call, exc, match):
    code = get_code(NAME)
    with pytest.raises(exc, match=match):
        call(torch.zeros((128, code.n)), code)


def test_done_in_without_early_stop_all_done():
    """done_in without early stop is the probe's second pass: an all-done
    batch decodes nothing and returns an output of the right shape."""
    code = get_code(NAME)
    out = mq.bp_qc_cuda(torch.zeros((128, code.n)), code.qc, iterations=10,
                        done_in=torch.ones(128, dtype=torch.bool))
    assert out.shape == (128, code.n) and out.dtype == torch.int8
