"""The port's gather backend (non-QC codes) and its bf16 roll arithmetic
against the JAX package.

* The gather backend (``ops/bp.py:_decode_graph``) on ref6432 and
  peg128_64 against JAX's ``auto`` (its dense backend on these codes) and
  JAX's ``backend='gather'``, 3 iterations on shared numpy LLRs:
  posteriors within rtol 1e-3 + atol 1e-5 (the dense backend routes with
  matmuls and both sum in other orders; sum-product-ref's log((1+p)/(1−p))
  near the ±(1−1e−7) clip magnifies a last-bit difference of p to ~1e-4
  relative) and hard bits equal wherever |JAX posterior| > 1e-4; early-stop
  bits and iteration counts equal.
* Reference parity: ``link_step`` on ref6432 with sum-product-ref-3 and
  clamp 20 within 4σ + 10% of ``BASELINE.md`` table A, the port of
  ``tests/test_chain.py:63``.
* The roll backend in bf16 arithmetic against JAX's bf16 roll backend on
  wifi648, 2 iterations of min-sum: posteriors within one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.ops import LinkConfig, bp_decode, link_step

RTOL, ATOL = 1e-3, 1e-5
HARD_MARGIN = 1e-4


def llrs(code, batch, seed, mu=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, code.n)) * 2.0 - mu).astype(np.float32)


def check_posteriors(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    sure = np.abs(ref) > HARD_MARGIN
    np.testing.assert_array_equal((ours < 0)[sure], (ref < 0)[sure])


@pytest.mark.parametrize("method", ["min-sum", "sum-product",
                                    "sum-product-ref"])
@pytest.mark.parametrize("name", ["ref6432", "peg128_64"])
def test_gather_matches_jax(name, method):
    code, jcode = get_code(name), jax_get_code(name)
    x = llrs(code, 64, seed=3)
    kw = dict(iterations=3, method=method, output="posterior",
              clamp=20.0 if method == "sum-product-ref" else None)
    ours = bp_decode(torch.from_numpy(x), code, **kw).numpy()
    assert torch.equal(torch.from_numpy(ours), bp_decode(
        torch.from_numpy(x), code, backend="gather", **kw))
    for backend in ("auto", "gather"):
        ref = np.asarray(jax_bp_decode(jnp.asarray(x), jcode,
                                       backend=backend, **kw))
        check_posteriors(ours, ref)


def random_edge_weights(code, iterations, seed):
    rng = np.random.default_rng(seed)
    g = code.graph
    shapes = {"w_msg": (iterations, g.n_vars, g.dv),
              "w_llr": (iterations, g.n_vars),
              "w_msg_final": (g.n_vars, g.dv), "w_llr_final": (g.n_vars,)}
    return {k: rng.uniform(0.7, 1.3, s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("case", ["alpha-beta-tuples", "msgq4", "weights",
                                  "ms-weights", "soft"])
def test_gather_options_match_jax(case):
    code, jcode = get_code("peg128_64"), jax_get_code("peg128_64")
    x = llrs(code, 32, seed=4)
    kw = dict(iterations=3, output="posterior", backend="gather")
    if case == "alpha-beta-tuples":
        kw.update(alpha=(0.8, 0.9, 1.0), beta=(0.1, 0.2, 0.0), clamp=6.0)
    elif case == "msgq4":
        kw.update(method="sum-product", msg_qbits=4, msg_qclip=8.0)
    elif case == "weights":
        kw.update(weights=random_edge_weights(code, 3, seed=5))
    elif case == "ms-weights":
        kw.update(weights={"ms_alpha": np.array([0.9, 0.8, 0.7], np.float32),
                           "ms_beta": np.array([0.0, 0.1, 0.2], np.float32)})
    else:
        kw.update(output="soft", method="sum-product-ref", clamp=20.0)
    ours = bp_decode(torch.from_numpy(x), code, **kw).numpy()
    ref = np.asarray(jax_bp_decode(jnp.asarray(x), jcode, **kw))
    if case == "soft":
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    else:
        check_posteriors(ours, ref)


def test_gather_early_stop_matches_jax():
    code, jcode = get_code("ref6432"), jax_get_code("ref6432")
    x = llrs(code, 256, seed=6, mu=3.0)
    kw = dict(iterations=3, method="sum-product-ref", clamp=20.0,
              early_stop=True, output="hard_iters")
    bits, iters = bp_decode(torch.from_numpy(x), code, **kw)
    jbits, jiters = jax_bp_decode(jnp.asarray(x), jcode, backend="gather",
                                  **kw)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert 0 < int((iters < 3).sum()) < 256


def test_gather_rejections():
    code = get_code("ref6432")
    x = torch.zeros((2, code.n))
    with pytest.raises(ValueError, match="int8 message storage"):
        bp_decode(x, code, dtype=torch.int8)
    with pytest.raises(ValueError, match="quasi-cyclic"):
        bp_decode(x, code, backend="roll")
    with pytest.raises(ValueError, match="cuda-only"):
        bp_decode(x, code, layered_group=2)
    with pytest.raises(ValueError, match="no kernel"):
        bp_decode(torch.zeros((2, 648)), get_code("wifi648"),
                  method="sum-product-ref", backend="cuda")


# BASELINE.md table A (the reference's stored run): coded BER and batch,
# as tests/test_chain.py:GOLDEN holds them
TABLE_A = {0.0: (7.271e-2, 4096), 3.0: (1.142e-2, 4096),
           6.0: (3.419e-4, 8192)}


@pytest.mark.parametrize("snrdb", sorted(TABLE_A))
def test_reference_parity(snrdb):
    """ref6432, QPSK/OFDM-32/AWGN, sum-product-ref-3, clamp 20: the coded
    BER within 4σ + 10% of table A."""
    code = get_code("ref6432")
    cfg = LinkConfig(bp_iterations=3, bp_method="sum-product-ref",
                     clamp=20.0)
    exp, batch = TABLE_A[snrdb]
    gen = torch.Generator()
    gen.manual_seed(42)
    out = link_step(gen, snrdb, code, cfg, batch)
    got = float(out["coded_bit_errors"]) / float(out["info_bits"])
    sigma = np.sqrt(exp * (1 - exp) / (batch * code.k))
    assert abs(got - exp) < 4 * sigma + 0.1 * exp, (got, exp)


def bf16_ulps(a, b):
    """|a − b| in bf16 ulps of b (values that are bf16-representable)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0**-126))) - 7)
    return np.abs(a - b) / ulp


@pytest.mark.parametrize("kw", [
    dict(schedule="flooding"),
    dict(schedule="layered", alpha=0.8, beta=0.15, clamp=20.0),
    dict(schedule="flooding", alpha=(0.86, 0.9), beta=(0.1, 0.2)),
], ids=["flooding", "layered-a-b-clamp", "flooding-tuples"])
def test_bf16_roll_matches_jax(kw):
    code, jcode = get_code("wifi648"), jax_get_code("wifi648")
    x = llrs(code, 16, seed=7, mu=-1.0)
    ours = bp_decode(torch.from_numpy(x), code, iterations=2,
                     dtype=torch.bfloat16, output="posterior", **kw).numpy()
    ref = np.asarray(jax_bp_decode(jnp.asarray(x), jcode, iterations=2,
                                   dtype=jnp.bfloat16, output="posterior",
                                   **kw), np.float32)
    assert bf16_ulps(ours, ref).max() <= 1.0
