"""Quantization in the port (CPU) against the JAX package: the decoder's
message quantization (``msg_qbits``/``msg_qclip``) and the receiver's ADC
(``quantize_complex``, the two AGCs and the quantized-ADC branch of
``link_step``).

Same numpy inputs into both packages. Quantized messages lie on a grid,
so the two decodes agree exactly in practice; the tests ask for equal
hard bits (min-sum) and posteriors within rtol = atol = 1e-4, and for
sum-product equal bits wherever the JAX posterior is farther than 1e-3
from 0. The ADC quantizer is exactly equal, halves on the grid included;
the AGCs are within 1e-6 relative; ``link_step`` frame errors within the
binomial 4σ bound of their difference, as in tests/test_torch_chain.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu.ops import link_step as jax_link_step
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import LinkConfig, bp_decode, link_step, phy


def channel_llrs(code, batch, mu, seed=0):
    """Consistent-Gaussian LLRs (mean ±mu, variance 2mu), log(Pr1/Pr0),
    of random codewords; row 0 is its codeword saturated at ±60."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, np.sqrt(2 * mu), cw.shape)
    llr[0] = (2.0 * cw[0] - 1.0) * 60.0
    return np.ascontiguousarray(llr, np.float32), cw


def jax_decode(llr, name, **kw):
    out = jax_bp_decode(jnp.asarray(llr), jax_get_code(name), backend="roll",
                        **kw)
    return tuple(map(np.asarray, out)) if isinstance(out, tuple) \
        else np.asarray(out)


# (code, schedule, msg_qbits, method)
CASES = [("wifi648", "flooding", q, "min-sum") for q in (3, 4, 5)] + [
    ("wifi648", "layered", 3, "min-sum"),
    ("wifi648", "layered", 5, "min-sum"),
    ("wifi1944", "flooding", 4, "min-sum"),
    ("wifi1944", "layered", 3, "min-sum"),
    ("wifi648", "layered", 4, "sum-product"),
    ("wifi1944", "flooding", 5, "sum-product"),
]


@pytest.mark.parametrize("name, schedule, qbits, method", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_msg_quant_matches_jax_roll(name, schedule, qbits, method):
    llr, cw = channel_llrs(jax_get_code(name), 16, 2.0)
    kw = dict(iterations=5, schedule=schedule, method=method, clamp=None,
              msg_qbits=qbits)
    ref = jax_decode(llr, name, output="posterior", **kw)
    code = get_code(name)
    post = bp_decode(torch.from_numpy(llr), code, output="posterior",
                     **kw).numpy()
    assert np.isfinite(post).all()
    np.testing.assert_allclose(post, ref, rtol=1e-4, atol=1e-4)
    ok = np.abs(ref) > 1e-3 if method == "sum-product" else slice(None)
    np.testing.assert_array_equal((post > 0)[ok], (ref > 0)[ok])
    np.testing.assert_array_equal(post[0] > 0, cw[0] == 1)
    bits = bp_decode(torch.from_numpy(llr), code, **kw)
    np.testing.assert_array_equal(bits.numpy(), post > 0)
    # every c2v message is on the grid k·step or at the clip ±20 =
    # ±(2^b − 1)/2 steps: a flooding posterior is its LLR plus a multiple
    # of half a step
    step = 2.0 * 20.0 / (2**qbits - 1)
    if schedule == "flooding":
        k = 2 * (post - llr) / step
        np.testing.assert_allclose(k, np.round(k), atol=1e-3)


def test_msg_quant_freeze_matches_jax_roll():
    """Early stop with quantized messages: iteration counts and bits."""
    name = "wifi648"
    llr, _ = channel_llrs(jax_get_code(name), 48, 3.0, seed=1)
    kw = dict(iterations=6, schedule="layered", method="min-sum",
              clamp=None, msg_qbits=4, early_stop=True)
    jbits, jiters = jax_decode(llr, name, output="hard_iters", **kw)
    bits, iters = bp_decode(torch.from_numpy(llr), get_code(name),
                            backend="roll", output="hard_iters", **kw)
    np.testing.assert_array_equal(iters.numpy(), jiters)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    assert (iters < 6).any() and (iters == 6).any()


def test_msg_quant_hard_unsat_and_done_in_match_jax_roll():
    name = "wifi648"
    code = get_code(name)
    llr, _ = channel_llrs(code, 32, 1.5, seed=2)
    kw = dict(iterations=4, schedule="flooding", clamp=None, msg_qbits=4)
    jbits = jax_decode(llr, name, method="min-sum", **kw)
    bits, unsat = mq.bp_qc_cuda(torch.from_numpy(llr), code.qc,
                                output="hard_unsat", **kw)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    H = code.H.astype(np.int64)
    np.testing.assert_array_equal(
        unsat.numpy(), ((jbits.astype(np.int64) @ H.T) % 2).sum(1))
    assert unsat[0] == 0 and (unsat > 0).any()
    done = torch.arange(32) % 4 == 1
    out = torch.full(llr.shape, 7, dtype=torch.int8)
    mq.bp_qc_cuda(torch.from_numpy(llr), code.qc, done_in=done, out=out,
                  **kw)
    assert (out[done] == 7).all()
    np.testing.assert_array_equal(out[~done].numpy(), jbits[~done.numpy()])


def test_msg_qclip_changes_the_decode_as_in_jax():
    """A clip other than the default 20 reaches the decode, in
    bp_decode as in JAX, and changes it."""
    name = "wifi648"
    llr, _ = channel_llrs(jax_get_code(name), 16, 2.0, seed=3)
    kw = dict(iterations=5, method="min-sum", clamp=None, msg_qbits=3,
              output="posterior")
    ref = jax_decode(llr, name, msg_qclip=6.0, **kw)
    code = get_code(name)
    post = bp_decode(torch.from_numpy(llr), code, msg_qclip=6.0, **kw)
    np.testing.assert_allclose(post.numpy(), ref, rtol=1e-4, atol=1e-4)
    default = bp_decode(torch.from_numpy(llr), code, **kw)
    assert not torch.equal(post, default)
    with pytest.raises(ValueError, match="must be a positive integer"):
        bp_decode(torch.from_numpy(llr), code, iterations=2, msg_qbits=0)


def test_link_step_passes_msg_qclip(monkeypatch):
    """link_step hands the decoder cfg.msg_qclip (and cfg.msg_qbits)."""
    import ldpc_sims_tpu_torch.ops.chain as chain

    seen = []
    real = chain.bp_decode

    def spy(llrs, code, **kw):
        seen.append(kw)
        return real(llrs, code, **kw)

    monkeypatch.setattr(chain, "bp_decode", spy)
    cfg = LinkConfig(bp_iterations=2, bp_method="min-sum", clamp=None,
                     msg_qbits=3, msg_qclip=6.0)
    link_step(torch.Generator(), 3.0, get_code("wifi648"), cfg, 8)
    assert seen[0]["msg_qbits"] == 3 and seen[0]["msg_qclip"] == 6.0


@pytest.mark.parametrize("legacy_clip", [True, False])
@pytest.mark.parametrize("num_bits", [1, 3, 5])
def test_quantize_complex_matches_jax(num_bits, legacy_clip):
    """Exactly JAX's values: random samples at a clip from a real AGC,
    and samples halfway between grid points at a clip whose step is a
    power of two, which floor(x/step + 0.5) rounds up."""
    rng = np.random.default_rng(num_bits)
    x = (rng.normal(size=(4, 6, 32))
         + 1j * rng.normal(size=(4, 6, 32))).astype(np.complex64)
    clip = np.float32(jax_phy.agc_global(jnp.asarray(x)))
    step = 0.25
    half_clip = np.float32(step * (2**num_bits - 1) / 2)
    k = np.arange(-40, 40, dtype=np.float32)
    halves = ((k + 0.5) * step + 1j * (k[::-1] + 0.5) * step).astype(
        np.complex64)
    for xs, c in ((x, clip), (halves, half_clip)):
        ref = np.asarray(jax_phy.quantize_complex(
            jnp.asarray(xs), num_bits, jnp.float32(c), legacy_clip))
        ours = phy.quantize_complex(torch.from_numpy(xs), num_bits, c,
                                    legacy_clip).numpy()
        np.testing.assert_array_equal(ours, ref)
    # halves go up, then the clip: ±(2^{b−1}·step − 1) legacy (the "− 1"
    # outside the product), else ±(2^{b−1} − 1)·step
    hi = (2**(num_bits - 1) * step - 1.0 if legacy_clip
          else (2**(num_bits - 1) - 1) * step)
    np.testing.assert_array_equal(
        ours.real, np.clip((k + 1) * step, -hi, hi))


def test_agcs_match_jax():
    rng = np.random.default_rng(5)
    rx = (rng.normal(0.1, 1.3, (4, 6, 32))
          + 1j * rng.normal(-0.2, 0.7, (4, 6, 32))).astype(np.complex64)
    ref = float(jax_phy.agc_global(jnp.asarray(rx)))
    ours = float(phy.agc_global(torch.from_numpy(rx)))
    assert abs(ours - ref) <= 1e-6 * ref
    snr = (10 ** (rng.uniform(0, 10, (4, 6)) / 10)).astype(np.float32)
    ref = np.asarray(jax_phy.agc_per_symbol(jnp.asarray(snr), 10.0, 1.5))
    ours = phy.agc_per_symbol(torch.from_numpy(snr), 10.0, 1.5).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


LINK = dict(bp_iterations=6, bp_method="min-sum", clamp=None)


@pytest.mark.parametrize("over, snrdb", [
    (dict(qbits=3, agc="global"), 8.5),
    (dict(qbits=3, agc="per-symbol"), 4.5),
    (dict(msg_qbits=4), 3.0),
], ids=["adc3-global", "adc3-per-symbol", "msgq4"])
def test_link_step_frame_errors_match_jax(over, snrdb):
    """wifi648 flooding-6 over QPSK/OFDM-32, 256 codewords, at an SNR in
    each configuration's waterfall: frame-error counts within the
    binomial 4σ bound of their difference; the uncoded BER counts the
    ideal ADC's LLRs, so it stays at the QPSK value."""
    batch = 256
    jout = jax_link_step(jax.random.key(2), jnp.float32(snrdb),
                         jax_get_code("wifi648"),
                         JaxLinkConfig(**LINK, **over), batch)
    gen = torch.Generator()
    gen.manual_seed(2)
    out = link_step(gen, snrdb, get_code("wifi648"), LinkConfig(**LINK, **over),
                    batch)
    f_jax, f_ours = int(jout["frame_errors"]), int(out["frame_errors"])
    p = (f_jax + f_ours) / (2 * batch)
    assert 0.2 < p < 0.8
    assert abs(f_jax - f_ours) <= 4 * math.sqrt(2 * batch * p * (1 - p))
    q = 0.5 * math.erfc(math.sqrt(10 ** (snrdb / 10)) / math.sqrt(2))
    nbits = batch * 648
    ber = int(out["uncoded_bit_errors"]) / nbits
    assert abs(ber - q) < 4 * math.sqrt(q * (1 - q) / nbits)


def test_link_step_quantized_arrays():
    """return_arrays adds the quantized LLRs and samples; with the
    global AGC every sample is on the ADC's grid of 2^b levels, CP
    included, and the per-symbol AGC gives the JAX shapes too."""
    code = get_code("wifi648")
    cfg = LinkConfig(**LINK, qbits=2, agc="global", cyclic_prefix=4)
    gen = torch.Generator()
    gen.manual_seed(4)
    out = link_step(gen, 6.0, code, cfg, 16, return_arrays=True)
    assert out["qllrs"].shape == out["llrs"].shape == (16, 648)
    assert out["q_time"].shape == out["rx_time"].shape == (2, 81, 32)
    assert not torch.equal(out["qllrs"], out["llrs"])
    assert len(torch.unique(out["q_time"].real)) <= 4
    # the JAX package's keys (ldpc_sims_tpu/ops/chain.py:245-269)
    assert set(out) == {
        "uncoded_bit_errors", "coded_bit_errors", "frame_errors",
        "uncoded_bits", "info_bits", "frames", "llrs", "coded", "rx_time",
        "tx_time", "snr_sym", "qllrs", "q_time"}
    per = dataclasses.replace(cfg, agc="per-symbol")
    out = link_step(gen, 6.0, code, per, 16, return_arrays=True)
    assert out["q_time"].shape == (2, 81, 32)
    with pytest.raises(ValueError, match="unknown agc"):
        link_step(gen, 6.0, code, dataclasses.replace(cfg, agc="x"), 8)
