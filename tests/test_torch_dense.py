"""The port's dense backend, pair-flavor weights, bare Tanner graphs and
syndromes against the JAX package (CPU).

* ``backend='dense'`` against JAX's ``backend='dense'`` on ref6432 and
  peg128_64 (one Ec×Ec routing product) and on the bare graph of wifi648
  (Ec = 2592 > 1024 padded edges: the factored routing), 3 iterations on
  shared numpy LLRs: posteriors within rtol 1e-5 + atol 1e-5 (1e-3
  relative for sum-product-ref, whose log((1+p)/(1−p)) near the
  ±(1−1e−7) clip magnifies a last-bit difference of p, as in
  tests/test_torch_gather.py), hard bits equal wherever |JAX posterior| >
  1e-4; early-stop bits and iteration counts equal. Both packages refuse
  a code with n·Ec > 2^26.
* ``syndrome`` and ``syndrome_from_bits_nb`` equal to JAX's exactly;
  ``decode_to_bits``; a bare graph equal to its code.
* Pair-flavor weights (``w_pair``) against JAX's gather backend within
  rtol 1e-5, and JAX's routing of them: ``auto`` → gather, any other
  explicit backend a ``ValueError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.codes.tanner import TannerGraph as JaxTannerGraph
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu.ops.bp import decode_to_bits as jax_decode_to_bits
from ldpc_sims_tpu.ops.bp import init_neural_bp_weights as jax_init_weights
from ldpc_sims_tpu.ops.bp import syndrome as jax_syndrome
from ldpc_sims_tpu.ops.bp import syndrome_from_bits_nb as jax_syndrome_nb
from ldpc_sims_tpu_torch.codes import TannerGraph, get_code
from ldpc_sims_tpu_torch.ops import (
    bp_decode,
    decode_to_bits,
    init_neural_bp_weights,
    pack_decoder_weights,
    syndrome,
    syndrome_from_bits_nb,
)

RTOL = {"min-sum": 1e-5, "sum-product": 1e-5, "sum-product-ref": 1e-3}
ATOL = 1e-5
HARD_MARGIN = 1e-4


def llrs(code, batch, seed, mu=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, code.n)) * 2.0 - mu).astype(np.float32)


def check_posteriors(ours, ref, rtol=1e-5):
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=ATOL)
    sure = np.abs(ref) > HARD_MARGIN
    np.testing.assert_array_equal((ours < 0)[sure], (ref < 0)[sure])


@pytest.mark.parametrize("method", ["min-sum", "sum-product",
                                    "sum-product-ref"])
@pytest.mark.parametrize("name", ["ref6432", "peg128_64"])
def test_dense_matches_jax(name, method):
    code, jcode = get_code(name), jax_get_code(name)
    assert code.graph.n_checks * code.graph.dc <= 1024  # the W_v product
    x = llrs(code, 64, seed=3)
    kw = dict(iterations=3, method=method, output="posterior",
              backend="dense",
              clamp=20.0 if method == "sum-product-ref" else None)
    ours = bp_decode(torch.from_numpy(x), code, **kw).numpy()
    ref = np.asarray(jax_bp_decode(jnp.asarray(x), jcode, **kw))
    check_posteriors(ours, ref, RTOL[method])


def random_edge_weights(code, iterations, seed, pair=False):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            for k, v in init_neural_bp_weights(
                code, iterations, flavor="pair" if pair else "edge").items()}


@pytest.mark.parametrize("case", ["alpha-beta-tuples-clamp", "msgq4",
                                  "weights", "ms-weights", "soft"])
def test_dense_options_match_jax(case):
    code, jcode = get_code("peg128_64"), jax_get_code("peg128_64")
    x = llrs(code, 32, seed=4)
    kw = dict(iterations=3, output="posterior", backend="dense")
    if case == "alpha-beta-tuples-clamp":
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
        np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=ATOL)
    else:
        check_posteriors(ours, ref)


def test_dense_early_stop_matches_jax():
    """es_mode='freeze' on the dense backend, its syndrome a product with
    H: bits and iteration counts equal to JAX's."""
    code, jcode = get_code("ref6432"), jax_get_code("ref6432")
    x = llrs(code, 256, seed=6, mu=3.0)
    kw = dict(iterations=3, method="sum-product-ref", clamp=20.0,
              early_stop=True, output="hard_iters", backend="dense")
    bits, iters = bp_decode(torch.from_numpy(x), code, **kw)
    jbits, jiters = jax_bp_decode(jnp.asarray(x), jcode, **kw)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert 0 < int((iters < 3).sum()) < 256
    assert torch.equal(bits, bp_decode(torch.from_numpy(x), code,
                                       **dict(kw, backend="gather"))[0])


@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
def test_factored_dense_matches_jax(method):
    """wifi648's bare graph, Ec = 2592 > 1024: L_exp @ (M_fin @ x + lv) − x
    (JAX's _dot_split products, the port's exact ones)."""
    code, jcode = get_code("wifi648"), jax_get_code("wifi648")
    g = code.graph
    assert g.n_checks * g.dc > 1024
    x = llrs(code, 16, seed=7)
    kw = dict(iterations=3, method=method, output="posterior",
              backend="dense")
    ours = bp_decode(torch.from_numpy(x), g, **kw).numpy()
    ref = np.asarray(jax_bp_decode(jnp.asarray(x), jcode.graph, **kw))
    check_posteriors(ours, ref)


def test_dense_refuses_large_codes():
    """n·Ec > 2^26: both packages refuse the factored routing."""
    m, n, dc = 4096, 8192, 6
    H = np.zeros((m, n), np.uint8)
    for c in range(m):  # 24576 edges, 2048 + 1 columns apart
        H[c, (c * 2 + np.arange(dc) * 2049) % n] = 1
    assert n * m * dc > 1 << 26
    x = np.zeros((2, n), np.float32)
    with pytest.raises(ValueError, match="too large for factored dense"):
        bp_decode(torch.from_numpy(x), TannerGraph.from_H(H),
                  backend="dense")
    with pytest.raises(ValueError, match="too large for factored dense"):
        jax_bp_decode(jnp.asarray(x), JaxTannerGraph.from_H(H),
                      backend="dense")


def test_dense_ignores_matmul_precision():
    """The routing products are exact whatever the float32 matmul
    precision asks for: the decode equals the one at 'highest'."""
    code = get_code("peg128_64")
    x = torch.from_numpy(llrs(code, 32, seed=8))
    kw = dict(iterations=3, backend="dense", output="hard_iters",
              early_stop=True)
    ref = bp_decode(x, code, **kw)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        out = bp_decode(x, code, **kw)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("name", ["ref6432", "peg128_64"])
def test_syndromes_match_jax(name):
    code, jcode = get_code(name), jax_get_code(name)
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (24, code.n)).astype(np.int8)
    bits[0] = code.encode_np(rng.integers(0, 2, (1, code.k)))[0]
    ours = syndrome(torch.from_numpy(bits), code.H)
    ref = np.asarray(jax_syndrome(jnp.asarray(bits), jcode.H))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not ours[0].any() and ours[1:].any()
    nb = syndrome_from_bits_nb(torch.from_numpy(bits.T.astype(np.int32)),
                               code.graph)
    ref_nb = np.asarray(jax_syndrome_nb(jnp.asarray(bits.T, jnp.int32),
                                        jcode.graph))
    np.testing.assert_array_equal(nb.numpy(), ref_nb)
    np.testing.assert_array_equal(nb.numpy().T, ref)


def test_decode_to_bits_matches_jax():
    """The reference's decode_bits API: sum-product-ref, clamp 20."""
    code, jcode = get_code("ref6432"), jax_get_code("ref6432")
    x = llrs(code, 64, seed=10)
    ours = decode_to_bits(torch.from_numpy(x), code, 3)
    ref = np.asarray(jax_decode_to_bits(jnp.asarray(x), jcode, 3))
    post = np.asarray(jax_bp_decode(jnp.asarray(x), jcode, iterations=3,
                                    method="sum-product-ref", clamp=20.0,
                                    output="posterior"))
    assert ours.dtype == torch.int8
    sure = np.abs(post) > HARD_MARGIN
    np.testing.assert_array_equal(ours.numpy()[sure], ref[sure])
    assert torch.equal(ours, decode_to_bits(torch.from_numpy(x), code.graph,
                                            3))


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_bare_graph_equals_its_code(backend):
    code = get_code("peg128_64")
    x = torch.from_numpy(llrs(code, 16, seed=11))
    kw = dict(iterations=3, backend=backend, output="posterior",
              weights=random_edge_weights(code, 3, seed=12))
    assert torch.equal(bp_decode(x, code.graph, **kw),
                       bp_decode(x, code, **kw))
    assert set(init_neural_bp_weights(code.graph, 3)) == set(kw["weights"])


@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
def test_pair_weights_match_jax(method):
    """Random pair weights in [0.7, 1.3] (w_msg and w_pair both), auto →
    gather in both packages."""
    code, jcode = get_code("peg128_64"), jax_get_code("peg128_64")
    x = llrs(code, 16, seed=13)
    w = random_edge_weights(code, 3, seed=14, pair=True)
    assert set(w) == set(jax_init_weights(jcode, 3, flavor="pair"))
    assert w["w_pair"].shape == (3, code.n, code.graph.dv, code.graph.dv)
    kw = dict(iterations=3, method=method, output="posterior")
    ours = bp_decode(torch.from_numpy(x), code, weights=w, **kw).numpy()
    ref = np.asarray(jax_bp_decode(
        jnp.asarray(x), jcode, weights={k: jnp.asarray(v)
                                        for k, v in w.items()}, **kw))
    check_posteriors(ours, ref)
    assert np.array_equal(ours, bp_decode(
        torch.from_numpy(x), code, weights=w, backend="gather", **kw).numpy())
    packed = pack_decoder_weights(w, code, 3, "cpu")  # the sweep's path
    assert set(packed) == set(w)
    assert np.array_equal(ours, bp_decode(torch.from_numpy(x), code,
                                          weights=packed, **kw).numpy())


@pytest.mark.parametrize("backend", ["roll", "dense", "cuda"])
def test_pair_weights_need_gather(backend):
    """JAX's routing error for pair weights on any explicit backend other
    than gather ('cuda' in the port where JAX has 'pallas')."""
    code, jcode = get_code("wifi648"), jax_get_code("wifi648")
    w = init_neural_bp_weights(code, 2, flavor="pair")
    with pytest.raises(ValueError, match="need backend='gather'"):
        bp_decode(torch.zeros((2, code.n)), code, iterations=2, weights=w,
                  backend=backend)
    jw = jax_init_weights(jcode, 2, flavor="pair")
    with pytest.raises(ValueError, match="need backend='gather'"):
        jax_bp_decode(jnp.zeros((2, code.n)), jcode, iterations=2,
                      weights=jw, backend={"cuda": "pallas"}.get(backend,
                                                                 backend))


def test_pair_weights_refuse_layered():
    """A layered schedule with pair weights: JAX's auto sends them to its
    gather backend, which decodes flooding whatever the schedule; the port
    refuses, as its gather backend refuses any layered schedule."""
    code = get_code("wifi648")
    with pytest.raises(ValueError, match="layered schedule requires"):
        bp_decode(torch.zeros((2, code.n)), code, iterations=2,
                  schedule="layered",
                  weights=init_neural_bp_weights(code, 2, flavor="pair"))
