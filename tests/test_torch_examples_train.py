"""The training examples' steps, verdicts, mixture and paired frames.

* One training step of each example that has its own loop, against the
  JAX script's (``bp_decode(backend='roll', output='soft')`` under
  ``jax.value_and_grad``, then ``optax.adam`` or ``multi_transform``) on
  shared NumPy LLRs, wifi648 at batch 8, with each script's learning
  rates: ``train_minsum_tail7`` (layered-3 α/β), ``train_edge_1944``
  (flooding-3 per-edge) and ``train_edge_layered_1944`` under ``EL_JOINT``
  (layered-3 per-edge with α/β). The loss within rtol 1e-5; the gradients
  within rtol 1e-4 and atol 1e-8, but the joint case's within rtol 1e-4
  and 1e-4 × the leaf's largest gradient (``_tree_close``'s rule, as
  ``tests/test_torch_training_roll.py`` holds a layered per-edge
  gradient: the float32 sums of three layered sweeps with random weights
  differ from XLA's by ~1e-4 of the largest gradient, whatever its size);
  the updated weights within 1e-3 × the rate of optax's update applied to
  the port's gradients (the first adam step moves a weight by ±rate
  whatever a near-zero gradient's size, so a rounding of such a gradient
  moves it far from JAX's: the gradients are held to JAX's, the optimizer
  to optax's). Three JAX roll gradients: the file's XLA compiles.
* Each verdict function applied to the committed records gives their
  recorded verdicts, exactly.
* tail7's SNR mixture: its floor share 0.7 within 4σ and its ranges.
* Paired frames: two identical arms count the same errors, a point's
  frames are a function of (key, SNR, step) only, and the counts and the
  BER's standard error are those of the per-frame errors.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples import paired
from ldpc_sims_tpu_torch.examples import train_edge_1944 as edge
from ldpc_sims_tpu_torch.examples import train_edge_layered_1944 as el
from ldpc_sims_tpu_torch.examples import train_minsum_short as short
from ldpc_sims_tpu_torch.examples import train_minsum_tail7 as t7
from test_torch_training import _bpsk_llrs, _edge_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _artifact(name: str) -> dict:
    with open(os.path.join(ARTIFACTS, name)) as f:
        return json.load(f)


def _ms_weights(seed):
    rng = np.random.default_rng(seed)
    return {"ms_alpha": rng.uniform(0.7, 1.0, K).astype(np.float32),
            "ms_beta": rng.uniform(0.0, 0.2, K).astype(np.float32)}


def _tail7_case(code):
    def opt():
        return optax.adam(3e-3)

    return (_ms_weights(1), dict(schedule="layered"), opt,
            lambda w: t7.optimizer(w, 3e-3), t7.train_step, 3e-3, None)


def _edge_case(code):
    return (_edge_weights(code, K, 2), {}, lambda: optax.adam(0.003),
            lambda w: edge.optimizer(w, 0.003), edge.train_step, 0.003,
            None)


def _edge_layered_case(code):
    def opt():
        return optax.multi_transform(
            {"ms": optax.adam(0.01), "edge": optax.adam(2e-3)},
            lambda tree: {k: ("ms" if k.startswith("ms_") else "edge")
                          for k in tree})

    return ({**_edge_weights(code, K, 3), **_ms_weights(4)},
            dict(schedule="layered"), opt,
            lambda w: el.optimizer(w, 2e-3, 0.01), el.train_step, 2e-3,
            1e-4)


@pytest.mark.parametrize("case", [_tail7_case, _edge_case,
                                  _edge_layered_case],
                         ids=["tail7", "edge-flooding", "edge-layered-joint"])
def test_train_step_matches_jax(case):
    code, jcode = get_code("wifi648"), jax_get_code("wifi648")
    w0, kw, jax_opt, port_opt, step, lr, rel_atol = case(code)
    llr = _bpsk_llrs(code.n, 8, 2.0, seed=9)

    def loss_fn(w):
        p1 = jax_bp_decode(jnp.asarray(llr), jcode, iterations=K,
                           method="min-sum", weights=w, output="soft",
                           backend="roll", **kw)
        return -jnp.mean(jnp.log(1.0 - p1 + 1e-7))

    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(jw)

    w = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in w0.items()}
    loss = step(w, port_opt(w), code, torch.from_numpy(llr))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = {k: jnp.asarray(v.grad.numpy()) for k, v in w.items()}
    opt = jax_opt()
    updates, _ = opt.update(got, opt.init(jw))
    stepped = optax.apply_updates(jw, updates)
    for k in w0:
        want = np.asarray(grads[k])
        atol = 1e-8 if rel_atol is None else rel_atol * np.abs(want).max()
        np.testing.assert_allclose(np.asarray(got[k]), want, rtol=1e-4,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(w[k].detach().numpy(),
                                   np.asarray(stepped[k]), rtol=0,
                                   atol=1e-3 * lr, err_msg=k)


def _tail7_verdict():
    rec = _artifact("20260821-130350_tail7.json")
    got = t7.guard_verdict(rec["guard_errs"]["ctrl"],
                           rec["guard_errs"]["tail7"])
    return got, rec["verdict"]


def _edge_layered_verdict(name):
    rec = _artifact(name)
    k = rec["K"]
    got = el.parity_verdict(rec["ber"]["flooding-20"],
                            rec["ber"][f"layered-{k} per-edge"])
    return got, rec["parity_vs_flooding20"]


def _short_verdicts(name):
    rec = _artifact(name)
    fber = rec["arms"]["flooding20"]["ber"]
    arms = {a: v for a, v in rec["arms"].items() if a != "flooding20"}
    return ({a: short.parity_vs_flooding20(v["ber"], fber)
             for a, v in arms.items()},
            {a: v["parity_vs_flooding20"] for a, v in arms.items()})


@pytest.mark.parametrize("verdicts", [
    _tail7_verdict,
    lambda: _edge_layered_verdict("20260821-102413_edge_layered1944_K6.json"),
    lambda: _edge_layered_verdict("20260821-104318_edge_layered1944_K6.json"),
    lambda: _edge_layered_verdict("20260821-105042_edge_layered1944_K5.json"),
    lambda: _short_verdicts("20260820_minsum_short.json"),
    lambda: _short_verdicts("20260821_minsum_short.json"),
], ids=["tail7", "edge-layered-K6-102413", "edge-layered-K6-104318",
        "edge-layered-K5", "minsum-short-0820", "minsum-short-0821"])
def test_verdicts_reproduce_committed_records(verdicts):
    got, want = verdicts()
    assert got == want


def test_tail7_mixture():
    gen = torch.Generator().manual_seed(5)
    n = 20000
    snr = t7.mixture_snr_db(gen, n)
    assert snr.shape == (n, 1)
    hi = snr >= 2.25
    share = float(hi.to(torch.float64).mean())
    assert abs(share - 0.7) <= 4 * math.sqrt(0.7 * 0.3 / n)
    assert float(snr[hi].min()) >= 2.25 and float(snr[hi].max()) < 3.75
    assert float(snr[~hi].min()) >= 1.25 and float(snr[~hi].max()) < 2.25
    # both ranges filled, not a point mass
    assert float(snr[hi].max()) > 3.6 and float(snr[~hi].min()) < 1.4
    llr = t7.mixture_llrs(torch.Generator().manual_seed(5), get_code(
        "wifi648"), 16)
    assert llr.shape == (16, 648) and torch.isfinite(llr).all()


def test_paired_frames():
    code, dev = get_code("wifi648"), torch.device("cpu")
    kw = dict(iterations=3, schedule="layered")
    a = paired.count_errors(code, kw, 1.75, 2, 16, 55, dev)
    b = paired.count_errors(code, kw, 1.75, 2, 16, 55, dev)
    assert a == b and a[0] > 0 and 0 < a[1] <= 32
    # the frames are a function of (key, SNR, step): the same for any arm
    x = paired.bpsk_llrs(code, 1.75, paired.frame_seed(55, 1.75, 1), 16,
                         dev)
    assert torch.equal(x, paired.bpsk_llrs(
        code, 1.75, paired.frame_seed(55, 1.75, 1), 16, dev))
    assert not torch.equal(x, paired.bpsk_llrs(
        code, 1.75, paired.frame_seed(55, 1.75, 2), 16, dev))
    # the counts and the standard error against the per-frame errors
    from ldpc_sims_tpu_torch.ops import bp_decode

    per_frame = torch.cat([bp_decode(paired.bpsk_llrs(
        code, 1.75, paired.frame_seed(55, 1.75, i), 16, dev), code, **kw)
        .sum(1, dtype=torch.int64) for i in range(2)]).numpy()
    assert (a.bit_errs, a.frame_errs, a.frames, a.bits) == (
        per_frame.sum(), (per_frame > 0).sum(), 32, 32 * code.n)
    np.testing.assert_allclose(
        a.ber_se, per_frame.std() / math.sqrt(32) / code.n, rtol=1e-9)
    # the info-bit count is the first k bits' share of the coded count
    info = paired.count_errors(code, kw, 1.75, 2, 16, 55, dev,
                               info_bits=True)
    assert info.bit_errs <= a.bit_errs and info.frame_errs <= a.frame_errs
    assert info.bits == 32 * code.k
