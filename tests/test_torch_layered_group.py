"""The group-serial layered schedule (``layered_group = G > 1``) in the port
(CPU) against the JAX package.

JAX has it in its Pallas kernel only, so the port's plain version is held
to ``bp_qc_pallas(..., interpret=True)`` on the same numpy LLRs: posteriors
within rtol = atol = 1e-4 and bits equal wherever the JAX posterior is
farther than 1e-3 from 0 (equal in practice), early-stop bits and
iteration counts exactly. Each interpret-mode call costs about 11 s on
the CPU at wifi648, batch 128: one per case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels import bp_qc_pallas
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import bp_decode
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll

NAME = "wifi648"


def assert_posteriors_match(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    sure = np.abs(ref) > 1e-3
    np.testing.assert_array_equal((ours > 0)[sure], (ref > 0)[sure])


def noisy_llrs(batch, seed=0):
    """N(0, 3²) LLRs: far from any codeword, the hardest case for
    agreement (what tests/test_kernels.py:495 uses)."""
    rng = np.random.default_rng(seed)
    n = get_code(NAME).n
    return rng.normal(0, 3, (batch, n)).astype(np.float32)


@pytest.mark.parametrize("group", [3, 12], ids=["G3", "Gmb"])
def test_group_serial_matches_pallas_interpret(group):
    """G = 3 (three serial groups of four rows) and G = mb (one group:
    flooding up to the order of the sums) against the JAX kernel."""
    llr = noisy_llrs(128)
    ref = np.array(bp_qc_pallas(
        jnp.asarray(llr), jax_get_code(NAME).qc, iterations=2,
        method="min-sum", schedule="layered", layered_group=group,
        interpret=True, output="posterior"))
    code = get_code(NAME)
    ours = bp_decode(torch.from_numpy(llr), code, iterations=2,
                     schedule="layered", layered_group=group,
                     backend="cuda", output="posterior")
    assert_posteriors_match(ours.numpy(), ref)
    # the schedule family: G = mb is flooding within the tolerance, and
    # an intermediate G is neither end
    flood = bp_decode(torch.from_numpy(llr), code, iterations=2,
                      output="posterior").numpy()
    serial = bp_decode(torch.from_numpy(llr), code, iterations=2,
                       schedule="layered", output="posterior").numpy()
    if group == code.qc.mb:
        np.testing.assert_allclose(ours.numpy(), flood, rtol=1e-4, atol=1e-4)
    else:
        assert not np.allclose(ours.numpy(), flood, atol=1e-4)
        assert not np.allclose(ours.numpy(), serial, atol=1e-4)


def test_group_serial_early_stop_matches_pallas_interpret():
    """Early stop under G = 3: bits and per-codeword iterations exactly."""
    jcode = jax_get_code(NAME)
    rng = np.random.default_rng(1)
    cw = jcode.encode_np(rng.integers(0, 2, (128, jcode.k)))
    llr = ((2.0 * cw - 1.0) * 2.0
           + rng.normal(0, 1.0, cw.shape)).astype(np.float32)
    jbits, jiters = bp_qc_pallas(
        jnp.asarray(llr), jcode.qc, iterations=10, method="min-sum",
        schedule="layered", layered_group=3, early_stop=True,
        output="hard_iters", interpret=True)
    bits, iters = bp_decode(torch.from_numpy(llr), get_code(NAME),
                            iterations=10, schedule="layered",
                            layered_group=3, early_stop=True,
                            output="hard_iters")
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert len(set(iters.tolist())) > 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(method="sum-product"),
    dict(msg_qbits=4, clamp=8.0),
    dict(alpha=0.8, beta=0.1),
], ids=["min-sum", "sum-product", "msgq4-clamp", "alpha-beta"])
def test_group_one_is_the_serial_path(kw):
    """G = 1 is the serial-C schedule bit for bit, in every check rule."""
    code = get_code(NAME)
    llr = torch.from_numpy(noisy_llrs(16, seed=2))
    a = decode_roll(llr, code.qc, iterations=3, schedule="layered",
                    layered_group=1, output="posterior", **kw)
    b = bp_decode(llr, code, iterations=3, schedule="layered",
                  output="posterior", **kw)
    assert torch.equal(a, b)


def test_group_serial_composes_with_the_drivers():
    """layered_group passes through both early-stop drivers: each equals
    the composition of its passes in the plain version with that G."""
    code = get_code(NAME)
    rng = np.random.default_rng(3)
    cw = code.encode_np(rng.integers(0, 2, (64, code.k)))
    mu = np.linspace(1.0, 8.0, 64)[:, None]
    llr = torch.from_numpy(((2.0 * cw - 1.0) * mu + rng.normal(
        0, 1, cw.shape) * np.sqrt(2 * mu)).astype(np.float32))
    g = dict(schedule="layered", layered_group=4)
    bits, iters = mq.bp_qc_requeue(llr, code.qc, 12, probe_iters=4,
                                   es_check_every=2, output="hard_iters",
                                   **g)
    es = dict(early_stop=True, es_check_every=2, output="hard_iters", **g)
    b1, i1 = decode_roll(llr, code.qc, iterations=4, **es)
    b2, i2 = decode_roll(llr, code.qc, iterations=12, **es)
    done = i1 < 4
    assert torch.equal(iters, torch.where(done, i1, 4 + i2))
    assert torch.equal(bits, torch.where(done[:, None], b1, b2))
    assert done.any() and not done.all()
    bits, iters = mq.bp_qc_probe_requeue(llr, code.qc, 12, probe_iters=3,
                                         output="hard_iters", **g)
    b1, u = decode_roll(llr, code.qc, iterations=3, output="hard_unsat", **g)
    b2 = decode_roll(llr, code.qc, iterations=12, **g)
    keep = (u == 0) & (64 - int((u == 0).sum()) <= mq.probe_capacity(64))
    assert torch.equal(bits, torch.where(keep[:, None], b1, b2))


def test_layered_group_validation():
    """The JAX package's errors (tests/test_kernels.py:555-562): a group
    needs the layered schedule, and it is the kernels' feature, not the
    roll backend's."""
    code = get_code(NAME)
    z = torch.zeros((128, code.n))
    with pytest.raises(ValueError, match="layered_group"):
        bp_decode(z, code, schedule="flooding", layered_group=2,
                  backend="cuda")
    with pytest.raises(ValueError, match="cuda-only"):
        bp_decode(z, code, schedule="layered", layered_group=2,
                  backend="roll")
    with pytest.raises(ValueError, match="layered_group"):
        mq.bp_qc_cuda(z, code.qc, 4, schedule="layered", layered_group=0)
