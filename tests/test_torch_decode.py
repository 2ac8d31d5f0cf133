"""The port's min-sum decode (plain version, CPU) against JAX's roll decode.

Same numpy LLRs into both packages; posteriors within rtol = atol = 1e-4
(the tolerance of tests/test_kernels.py), hard bits identical wherever
the JAX posterior is farther than 1e-3 from 0.

The two differ only in float rounding: the JAX flooding update sums the
posterior as LLR + (Σ c2v) where the port sums left to right, and XLA on
the CPU fuses α·m − c2v into one multiply-add where no clamp separates
them. Min-sum amplifies such last-bit differences only in codewords that
do not converge, so the unclamped cases of more than five iterations use
LLRs at which these codewords converge.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.convert import load_trained_schedule
from ldpc_sims_tpu_torch.kernels import bp_qc_cuda, minsum_qc_cuda
from ldpc_sims_tpu_torch.ops import bp_decode, freeze_minsum_weights

SCHEDULES = os.path.join(os.path.dirname(__file__), "..", "docs",
                         "artifacts", "minsum_trained_schedules.json")
A8, B8 = load_trained_schedule(SCHEDULES, "wifi1944", 8)

# (schedule, iterations, alpha, beta, clamp, LLR mean)
CASES = {
    "flooding-plain": ("flooding", 5, 1.0, 0.0, None, 2.0),
    "flooding-a0.75-b0.1-clamp20": ("flooding", 5, 0.75, 0.1, 20.0, 2.0),
    "layered-a0.8-b0.15": ("layered", 5, 0.8, 0.15, None, 2.0),
    "layered-plain-clamp20": ("layered", 5, 1.0, 0.0, 20.0, 2.0),
    "layered-trained8-clamp20": ("layered", 8, A8, B8, 20.0, 2.0),
    "layered-trained8": ("layered", 8, A8, B8, None, 3.0),
}


def channel_llrs(code, batch, mu, seed=0):
    """Consistent-Gaussian LLRs (mean ±mu, variance 2mu), log(Pr1/Pr0),
    of random codewords; returns (llr, codewords)."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, np.sqrt(2 * mu), cw.shape)
    return llr.astype(np.float32), cw


def assert_posteriors_match(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    sure = np.abs(ref) > 1e-3
    np.testing.assert_array_equal((ours > 0)[sure], (ref > 0)[sure])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_decode_matches_jax_roll(name, case):
    schedule, iters, alpha, beta, clamp, mu = CASES[case]
    llr, _ = channel_llrs(jax_get_code(name), 16, mu)
    kw = dict(iterations=iters, alpha=alpha, beta=beta, clamp=clamp,
              schedule=schedule)
    ref = np.asarray(jax_bp_decode(jnp.asarray(llr), jax_get_code(name),
                                   method="min-sum", backend="roll",
                                   output="posterior", **kw))
    code = get_code(name)
    post = bp_decode(torch.from_numpy(llr), code, output="posterior", **kw)
    assert post.dtype == torch.float32 and post.shape == llr.shape
    assert_posteriors_match(post.numpy(), ref)
    bits = bp_decode(torch.from_numpy(llr), code, **kw)
    assert bits.dtype == torch.int8
    np.testing.assert_array_equal(bits.numpy(), (post > 0).numpy())


def test_soft_output_matches_jax():
    name = "wifi648"
    llr, _ = channel_llrs(jax_get_code(name), 8, 2.0)
    ref = np.asarray(jax_bp_decode(jnp.asarray(llr), jax_get_code(name),
                                   iterations=3, method="min-sum",
                                   backend="roll", output="soft"))
    soft = bp_decode(torch.from_numpy(llr), get_code(name), iterations=3,
                     output="soft")
    np.testing.assert_allclose(soft.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_decode_corrects_errors():
    code = get_code("wifi1944")
    llr, cw = channel_llrs(code, 8, 4.0, seed=1)
    assert ((llr > 0) != cw).sum() > 0  # the channel made errors
    for schedule, iters in (("flooding", 20), ("layered", 8)):
        bits = bp_decode(torch.from_numpy(llr), code, iterations=iters,
                         alpha=A8 if schedule == "layered" else 1.0,
                         beta=B8 if schedule == "layered" else 0.0,
                         schedule=schedule)
        np.testing.assert_array_equal(bits.numpy(), cw)


@pytest.mark.parametrize("backend", ["auto", "roll", "cuda"])
def test_cpu_tensor_takes_plain_version(backend):
    """On a CPU tensor every backend, the kernel wrapper included, runs
    the plain version."""
    code = get_code("wifi648")
    llr = torch.from_numpy(channel_llrs(code, 4, 2.0)[0])
    ref = bp_decode(llr, code, iterations=4, backend="roll",
                    output="posterior")
    out = bp_decode(llr, code, iterations=4, backend=backend,
                    output="posterior")
    assert torch.equal(out, ref)
    assert torch.equal(bp_qc_cuda(llr, code.qc, iterations=4,
                                  output="posterior"), ref)
    assert torch.equal(minsum_qc_cuda(llr, code.qc, iterations=4),
                       (ref > 0).to(torch.int8))


def test_freeze_minsum_weights():
    a, b = freeze_minsum_weights({"ms_alpha": torch.tensor([0.5, 0.75]),
                                  "ms_beta": np.array([0.0, 0.25])})
    assert a == (0.5, 0.75) and b == (0.0, 0.25)


@pytest.mark.parametrize("kw, match", [
    (dict(method="sum-product"), "ROADMAP A4 and B5"),
    (dict(early_stop=True), "ROADMAP B3"),
    (dict(msg_qbits=4), "ROADMAP B8"),
    (dict(weights={"ms_alpha": np.ones(4)}), "ROADMAP A10"),
    (dict(layered_group=2, schedule="layered"), "ROADMAP B9"),
    (dict(output="hard_iters"), "ROADMAP B6"),
    (dict(dtype=torch.bfloat16), "ROADMAP B10"),
    (dict(backend="dense"), "ROADMAP A4"),
])
def test_unported_features_raise(kw, match):
    code = get_code("wifi648")
    llr = torch.zeros((2, code.n))
    with pytest.raises(NotImplementedError, match=match):
        bp_decode(llr, code, iterations=4, **kw)


def test_non_qc_code_not_ported():
    code = get_code("ref6432")
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        bp_decode(torch.zeros((2, code.n)), code, iterations=3)


@pytest.mark.parametrize("kw, match", [
    (dict(method="bogus"), "unknown method"),
    (dict(schedule="zigzag"), "unknown schedule"),
    (dict(es_mode="auto"), "sweep-engine dispatch"),
    (dict(output="bogus"), "unknown output"),
    (dict(backend="pallas"), "unknown backend"),
    (dict(alpha=(0.8, 0.9)), "needs length 4"),
])
def test_bad_arguments_raise(kw, match):
    code = get_code("wifi648")
    with pytest.raises(ValueError, match=match):
        bp_decode(torch.zeros((2, code.n)), code, iterations=4, **kw)
