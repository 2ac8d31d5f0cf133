"""The early-stop drivers (plain version, CPU) against the JAX package.

``es_mode='probe'`` (``bp_qc_probe_requeue``) on its compact path and on
its overflow path, and ``es_mode='requeue'`` (``bp_qc_requeue``), each
against the JAX function run through Pallas interpret mode on the same
numpy LLRs (the inputs of tests/test_kernels.py): bits and iteration
counts exactly equal. Then the probe schedule's prefix rule, which the
port keeps as the JAX package has it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_requeue as jax_requeue
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import bp_decode

NAME = "wifi648"


def awgn_llrs(batch, snrdb, seed):
    """BPSK all-zero codeword over AWGN at ``snrdb``: log(Pr1/Pr0)."""
    rng = np.random.default_rng(seed)
    snr = 10 ** (snrdb / 10.0)
    sigma = (1 / snr) ** 0.5
    r = 1.0 + sigma * rng.normal(0, 1, (batch, 648))
    return (-2.0 * r / (sigma * sigma)).astype(np.float32)


@pytest.mark.parametrize("batch, snrdb, iters, probe, overflow", [
    (256, 3.0, 12, 3, False),
    (512, 0.0, 8, 2, True),
], ids=["compact", "overflow"])
def test_probe_matches_jax(batch, snrdb, iters, probe, overflow):
    llr = awgn_llrs(batch, snrdb, seed=int(snrdb) + 1)
    kw = dict(iterations=iters, method="min-sum", schedule="layered",
              early_stop=True, es_mode="probe", es_probe_iters=probe,
              output="hard_iters")
    jbits, jiters = jax_bp_decode(jnp.asarray(llr), jax_get_code(NAME),
                                  backend="pallas", **kw)
    bits, got = bp_decode(torch.from_numpy(llr), get_code(NAME), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jiters))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    fixed = bp_decode(torch.from_numpy(llr), get_code(NAME),
                      iterations=iters, schedule="layered")
    strag = got > probe
    assert torch.equal(bits[strag], fixed[strag])
    if overflow:  # (B − n_done) > C = 128: every codeword re-decoded
        assert (got == probe + iters).all() and torch.equal(bits, fixed)
    else:
        assert strag.any() and (~strag).any()
        assert int(strag.sum()) <= mq.probe_capacity(batch)


def test_requeue_matches_jax():
    llr = awgn_llrs(128, 2.0, seed=3)
    kw = dict(iterations=8, probe_iters=4, es_check_every=2,
              schedule="layered", output="hard_iters")
    jbits, jiters = jax_requeue(jnp.asarray(llr), jax_get_code(NAME).qc,
                                interpret=True, **kw)
    bits, iters = mq.bp_qc_requeue(torch.from_numpy(llr), get_code(NAME).qc,
                                   **kw)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert (iters < 4).any() and (iters > 4).any()
    # the same through bp_decode's dispatch
    bits2, iters2 = bp_decode(
        torch.from_numpy(llr), get_code(NAME), iterations=8,
        schedule="layered", early_stop=True, es_mode="requeue",
        es_probe_iters=4, es_check_every=2, output="hard_iters")
    assert torch.equal(bits2, bits) and torch.equal(iters2, iters)


def test_probe_capacity_is_the_jax_formula():
    # C = min(B, max(tile, ceil(B / (4 tile)) tile)) on the batch padded
    # to 128 lanes
    assert [mq.probe_capacity(b) for b in (1, 128, 256, 512, 513, 4096,
                                           32768)] == \
        [128, 128, 128, 128, 256, 1024, 8192]


def test_probe_schedule_prefix_rule():
    """A per-iteration (α, β) with no probe schedule: the probe runs its
    first probe_iters entries. An explicit probe schedule longer than
    probe_iters is cut the same way, silently, as the JAX function does
    (ROADMAP §C); a shorter one raises."""
    code = get_code(NAME)
    llr = torch.from_numpy(awgn_llrs(128, 2.0, seed=4))
    al = tuple(1.0 - 0.02 * i for i in range(8))
    be = tuple(0.01 * i for i in range(8))
    kw = dict(iterations=8, schedule="layered", alpha=al, beta=be,
              early_stop=True, es_mode="probe", es_probe_iters=3,
              output="hard_iters")
    bits, iters = bp_decode(llr, code, **kw)
    ref = bp_decode(llr, code, es_probe_alpha=al[:3], es_probe_beta=be[:3],
                    **kw)
    long = bp_decode(llr, code, es_probe_alpha=al, es_probe_beta=be, **kw)
    for other in (ref, long):
        assert torch.equal(bits, other[0]) and torch.equal(iters, other[1])
    with pytest.raises(ValueError, match="2 entries for probe_iters=3"):
        bp_decode(llr, code, es_probe_alpha=al[:2], **kw)


def test_requeue_probe_schedule_prefix():
    """bp_qc_requeue's early-stop probe runs the schedule's prefix."""
    qc = get_code(NAME).qc
    llr = torch.from_numpy(awgn_llrs(32, 2.0, seed=5))
    al = tuple(1.0 - 0.02 * i for i in range(8))
    bits, iters = mq.bp_qc_requeue(llr, qc, 8, probe_iters=4, alpha=al,
                                   schedule="layered", output="hard_iters")
    b1, i1 = mq.bp_qc_cuda(llr, qc, 4, alpha=al[:4], schedule="layered",
                           early_stop=True, es_check_every=2,
                           output="hard_iters")
    done = i1 < 4
    assert torch.equal(iters[done], i1[done])
    assert torch.equal(bits[done], b1[done])
