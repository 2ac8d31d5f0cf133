"""Per-edge neural-BP weights in the port (CPU) against the JAX package.

Same numpy LLRs and weights into both packages; JAX decodes with its roll
backend, ``bp_decode(backend='roll', weights=...)``. Posteriors within
rtol = atol = 1e-4, bits equal wherever the JAX posterior is farther than
1e-3 from 0 (the tolerance of tests/test_kernels.py). XLA on the CPU
fuses some multiply-adds that the port does not, and min-sum amplifies
such last-bit differences only in codewords that do not converge, so the
LLRs are ones at which these codewords converge. Also: the committed
trained decoders, ``load_decoder_weights``, the ``sweep`` flags, and the
divergence of the two CLIs' defaults.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu.ops import link_step as jax_link_step
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.cli import main as cli_main
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.convert import decoder_weights_from_numpy
from ldpc_sims_tpu_torch.ops import (
    LinkConfig,
    bp_decode,
    init_minsum_weights,
    init_neural_bp_weights,
    link_step,
    pack_decoder_weights,
)
from ldpc_sims_tpu_torch.ops import bp as bp_mod
from ldpc_sims_tpu_torch.ops import bp_roll
from ldpc_sims_tpu_torch.parallel import SweepConfig, run_sweep
from ldpc_sims_tpu_torch.utils import load_decoder_weights

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs",
                         "artifacts")
K6 = os.path.join(ARTIFACTS, "edge_layered_1944_K6.npz")
K5 = os.path.join(ARTIFACTS, "edge_layered_1944_K5.npz")


def channel_llrs(code, batch, mu, seed=0):
    """Consistent-Gaussian LLRs (mean ±mu, variance 2mu), log(Pr1/Pr0),
    of random codewords; returns (llr, codewords)."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, np.sqrt(2 * mu), cw.shape)
    return np.ascontiguousarray(llr, np.float32), cw


def random_weights(code, iterations, seed=0):
    """Edge-flavor weights drawn from [0.7, 1.3], as numpy float32."""
    rng = np.random.default_rng(seed)
    ones = init_neural_bp_weights(code, iterations)
    return {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            for k, v in ones.items()}


def assert_posteriors_match(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    sure = np.abs(ref) > 1e-3
    np.testing.assert_array_equal((ours > 0)[sure], (ref > 0)[sure])


def jax_posterior(llr, name, **kw):
    return np.asarray(jax_bp_decode(jnp.asarray(llr), jax_get_code(name),
                                    method="min-sum", backend="roll",
                                    output="posterior", **kw))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_weighted_decode_matches_jax_roll(name, schedule):
    code = get_code(name)
    llr, _ = channel_llrs(code, 16, 3.0)
    w = random_weights(code, 2, seed=1)
    kw = dict(iterations=2, schedule=schedule, weights=w)
    ref = jax_posterior(llr, name, **kw)
    post = bp_decode(torch.from_numpy(llr), code, output="posterior", **kw)
    assert_posteriors_match(post.numpy(), ref)
    # the kernels' wrapper (its plain version here) and pre-packed tables
    # give the same decode
    cuda = bp_decode(torch.from_numpy(llr), code, output="posterior",
                     backend="cuda", **kw)
    packed = bp_decode(torch.from_numpy(llr), code, output="posterior",
                       **dict(kw, weights=pack_decoder_weights(
                           w, code, 2, "cpu")))
    assert torch.equal(cuda, post) and torch.equal(packed, post)


def test_trained_k6_matches_jax_roll():
    """The committed per-edge layered-6 decoder with its jointly trained
    ms_alpha/ms_beta, one dict into both packages: JAX decodes it on its
    roll backend (traced ms), the port as its kernels do (the ms arrays as
    the α/β table)."""
    w = load_decoder_weights(K6)
    code = get_code("wifi1944")
    llr, cw = channel_llrs(code, 16, 4.0, seed=2)
    kw = dict(iterations=6, schedule="layered", weights=w)
    ref = jax_posterior(llr, "wifi1944", **kw)
    for backend in ("roll", "cuda"):
        post = bp_decode(torch.from_numpy(llr), code, output="posterior",
                         backend=backend, **kw)
        assert_posteriors_match(post.numpy(), ref)
    np.testing.assert_array_equal((post.numpy() > 0), cw)
    # the ms arrays frozen to tuples are the same decode
    edge = {k: v for k, v in w.items() if k.startswith("w_")}
    frozen = bp_decode(torch.from_numpy(llr), code, output="posterior",
                       alpha=tuple(float(a) for a in w["ms_alpha"]),
                       beta=tuple(float(b) for b in w["ms_beta"]),
                       iterations=6, schedule="layered", weights=edge)
    assert torch.equal(frozen, post)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_identity_weights(schedule):
    """All-ones weights are plain BP: exactly for flooding, within the
    tolerance for layered, whose weighted form re-bases the posterior
    between sweeps in another order of the sums."""
    code = get_code("wifi648")
    llr = torch.from_numpy(np.random.default_rng(3).normal(
        0, 2, (32, code.n)).astype(np.float32))
    kw = dict(iterations=2, schedule=schedule, output="posterior")
    ones = bp_decode(llr, code, weights=init_neural_bp_weights(code, 2),
                     **kw)
    plain = bp_decode(llr, code, **kw)
    if schedule == "flooding":
        assert torch.equal(ones, plain)
    else:
        torch.testing.assert_close(ones, plain, rtol=1e-4, atol=1e-4)
    ms = bp_decode(llr, code, weights=init_minsum_weights(2), **kw)
    assert torch.equal(ms, plain)


def test_weights_gradient_through_the_plain_version():
    """The roll backend keeps the autograd graph (the training path); the
    kernels' path raises rather than drop the gradient."""
    code = get_code("wifi648")
    llr, _ = channel_llrs(code, 4, 2.0, seed=4)
    w = {k: v.requires_grad_() for k, v in
         init_neural_bp_weights(code, 2).items()}
    post = bp_decode(torch.from_numpy(llr), code, iterations=2, weights=w,
                     schedule="layered", output="posterior")
    post.sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in w.values())
    assert float(w["w_llr"].grad.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="carry no gradient"):
        bp_decode(torch.from_numpy(llr), code, iterations=2, weights=w,
                  backend="cuda")
    # LLRs that need a gradient too; under no_grad the kernels' path runs
    x = torch.from_numpy(llr).requires_grad_()
    with pytest.raises(NotImplementedError, match="carry no gradient"):
        bp_decode(x, code, iterations=2, backend="cuda")
    with torch.no_grad():
        assert torch.equal(
            bp_decode(x, code, iterations=2, weights=w, backend="cuda"),
            bp_decode(x, code, iterations=2, weights=w, backend="roll"))


@pytest.mark.parametrize("call, exc, match", [
    (dict(weights="es", early_stop=True), ValueError,
     "early stop|early_stop"),
    (dict(weights="ms", alpha=(0.8, 0.9)), ValueError,
     "pass tuple alpha/beta OR ms_alpha/ms_beta"),
    (dict(weights="ms", method="sum-product"), ValueError,
     "require method='min-sum'"),
    (dict(weights="ms3"), ValueError, r"ms_alpha must have shape \(2,\)"),
    (dict(weights="pair", backend="roll"), ValueError,
     "pair-flavor weights need backend='gather'"),
    (dict(weights="partial"), ValueError, "edge flavor"),
], ids=["early-stop", "tuple-and-ms", "ms-sum-product", "ms-length",
        "pair", "partial"])
def test_weight_validation(call, exc, match):
    """JAX's rejections (tests/test_kernels.py:100-108, ops/bp.py:458-513)."""
    code = get_code("wifi648")
    w = init_neural_bp_weights(code, 2)
    weights = {
        "es": w,
        "ms": {**w, **init_minsum_weights(2)},
        "ms3": init_minsum_weights(3),
        "pair": {**w, "w_pair": np.ones(1)},
        "partial": {"w_msg": w["w_msg"]},
    }[call.pop("weights")]
    with pytest.raises(exc, match=match):
        bp_decode(torch.zeros((8, code.n)), code, iterations=2,
                  weights=weights, **call)
    pair = init_neural_bp_weights(code, 2, flavor="pair")
    assert pair["w_pair"].shape == (2, code.n, code.graph.dv,
                                    code.graph.dv)
    with pytest.raises(ValueError, match="unknown flavor"):
        init_neural_bp_weights(code, 2, flavor="bogus")


def test_packed_tables_and_shape_errors():
    code = get_code("wifi648")
    w = init_neural_bp_weights(code, 3)
    t = bp_roll.pack_edge_weights(w, code.qc, 3)
    P = len(bp_roll.qc_plan(code.qc)[0])
    assert t.msg.shape == (4, P, code.qc.z)
    assert t.llr.shape == (4, code.qc.nb, code.qc.z)
    dv = code.graph.dv
    with pytest.raises(ValueError, match=rf"w_msg shape \(3, 648, {dv}\) "
                                         r"!= \(2, 648, dv\)"):
        bp_roll.pack_edge_weights(w, code.qc, 2)
    bad = dict(w, w_llr=torch.ones((3, 10)))
    with pytest.raises(ValueError, match="w_llr shape"):
        bp_roll.pack_edge_weights(bad, code.qc, 3)
    # the table entry of an edge is the variable-space weight of its slot
    rng = np.random.default_rng(5)
    w = random_weights(code, 1, seed=5)
    t = bp_roll.pack_edge_weights(w, code.qc, 1)
    planes, _, group_v = bp_roll.qc_plan(code.qc)
    z = code.qc.z
    for _ in range(20):
        p, r = int(rng.integers(len(planes))), int(rng.integers(z))
        _, j, s = planes[p]
        kv = group_v[j].index(p)
        v = j * z + (r + s) % z
        assert float(t.msg[0, p, r]) == w["w_msg"][0, v, kv]
        assert float(t.msg[1, p, r]) == w["w_msg_final"][v, kv]


@pytest.mark.parametrize("path, iters", [(K5, 5), (K6, 6)], ids=["K5", "K6"])
def test_load_decoder_weights_npz(path, iters):
    w = load_decoder_weights(path)
    assert set(w) == {"w_msg", "w_llr", "w_msg_final", "w_llr_final",
                      "ms_alpha", "ms_beta"}
    assert w["w_msg"].shape == (iters, 1944, 11)
    assert w["ms_alpha"].shape == (iters,)
    z = np.load(path)
    for k in w:
        np.testing.assert_array_equal(w[k], z[k])
    t = decoder_weights_from_numpy(w, "cpu")
    assert all(v.dtype == torch.float32 for v in t.values())


def test_load_decoder_weights_errors(tmp_path):
    bad = str(tmp_path / "llr_model.npz")
    np.savez(bad, dense_0=np.ones(3))
    with pytest.raises(ValueError, match="expected decoder-weight keys"):
        load_decoder_weights(bad)
    # a checkpoint directory loads (the JAX package's format: the
    # decoder keys under "params"); an LLR model's directory is refused
    from ldpc_sims_tpu_torch.utils import save_checkpoint

    ms = {"ms_alpha": np.float32([0.8, 0.9]),
          "ms_beta": np.float32([0.1, 0.0])}
    ckpt = save_checkpoint(str(tmp_path / "ms"), {"params": ms,
                                                  "opt_state": None})
    w = load_decoder_weights(ckpt)
    assert set(w) == set(ms)
    for k in ms:
        np.testing.assert_array_equal(w[k], ms[k])
    llr = save_checkpoint(str(tmp_path / "llr"), {"params": {"params": {
        "final": {"kernel": np.ones((2, 2), np.float32)}}}})
    with pytest.raises(ValueError, match="expected decoder-weight keys"):
        load_decoder_weights(llr)


def test_link_step_with_weights_matches_jax():
    """The slice as a whole: wifi648 QPSK/OFDM-32 through link_step with a
    per-edge layered-3 decoder (random weights and ms arrays) in both
    packages, 128 codewords at 2.5 dB; frame-error counts within the
    binomial 4σ bound of their difference. (The committed K6 decoder's
    decode is held to JAX above; its unrolled JAX link step takes ~40 s to
    compile.)"""
    batch, snrdb = 128, 2.5
    code = get_code("wifi648")
    w = {**random_weights(code, 3, seed=6), "ms_alpha": np.float32(
        [0.8, 0.85, 0.9]), "ms_beta": np.float32([0.1, 0.05, 0.0])}
    link = dict(bp_iterations=3, bp_method="min-sum", clamp=None,
                bp_schedule="layered")
    jout = jax_link_step(jax.random.key(3), jnp.float32(snrdb),
                         jax_get_code("wifi648"), JaxLinkConfig(**link),
                         batch, weights=w)
    gen = torch.Generator()
    gen.manual_seed(3)
    out = link_step(gen, snrdb, code, LinkConfig(**link), batch, weights=w)
    f_jax, f_ours = int(jout["frame_errors"]), int(out["frame_errors"])
    p = (f_jax + f_ours) / (2 * batch)
    assert 0.02 < p < 0.98
    assert abs(f_jax - f_ours) <= 4 * math.sqrt(2 * batch * p * (1 - p))


def test_sweep_packs_the_weights_once(monkeypatch):
    """run_sweep moves and packs the weights once, not in every step."""
    packs = []
    real = bp_roll.pack_edge_weights

    def counting(weights, *a, **kw):
        if not isinstance(weights, bp_roll.EdgeTables):
            packs.append(1)
        return real(weights, *a, **kw)

    monkeypatch.setattr(bp_roll, "pack_edge_weights", counting)
    monkeypatch.setattr(bp_mod, "pack_edge_weights", counting)
    code = get_code("wifi648")
    cfg = LinkConfig(bp_iterations=3, bp_method="min-sum", clamp=None,
                     bp_schedule="layered")
    sweep = SweepConfig(snrdb=(2.0,), batch_cw=16, max_info_bits=3 * 16 * 324,
                        min_info_bits=0, target_frame_errors=10**9)
    res = run_sweep(code, cfg, sweep, weights=random_weights(code, 3),
                    log=None, device="cpu")
    assert res.frames == [48.0] and packs == [1]


def cut_sweeps(monkeypatch):
    """The CLI's run_sweep cut to one point of 8 codewords; records each
    call's (link, weights)."""
    import ldpc_sims_tpu_torch.parallel as par

    calls = []
    real = par.run_sweep

    def short(code, link, sweep, **kw):
        calls.append((link, kw.get("weights")))
        return real(code, link, dataclasses.replace(
            sweep, snrdb=(3.0,), batch_cw=8, steps_per_sync=1,
            max_info_bits=1, min_info_bits=0), **kw)

    monkeypatch.setattr(par, "run_sweep", short)
    return calls


def curves(tmp_path):
    name, = [f for f in os.listdir(tmp_path) if f.endswith("_curves.json")]
    with open(tmp_path / name) as f:
        return json.load(f)


def test_cli_weights_ckpt(tmp_path, monkeypatch):
    calls = cut_sweeps(monkeypatch)
    cli_main(["sweep", "--code", "wifi1944", "--method", "min-sum",
              "--clamp", "0", "--schedule", "layered", "--iters", "6",
              "--weights-ckpt", K6, "--device", "cpu", "--out",
              str(tmp_path)])
    (link, weights), = calls
    assert link.bp_schedule == "layered" and link.bp_iterations == 6
    assert set(weights) == set(np.load(K6).files)
    rec = curves(tmp_path)
    assert rec["code"] == "wifi1944_r12"
    assert rec["coded_ber"][0] < rec["uncoded_ber"][0]


def test_cli_schedule_ckpt_and_layered_group(tmp_path, monkeypatch):
    calls = cut_sweeps(monkeypatch)
    cli_main(["sweep", "--code", "wifi1944", "--method", "min-sum",
              "--clamp", "0", "--schedule", "layered", "--iters", "5",
              "--schedule-ckpt", K5, "--layered-group", "4",
              "--device", "cpu", "--out", str(tmp_path)])
    (link, weights), = calls
    z = np.load(K5)
    assert weights is None and link.bp_layered_group == 4
    assert link.alpha == tuple(float(a) for a in z["ms_alpha"])
    assert link.beta == tuple(float(b) for b in z["ms_beta"])
    assert curves(tmp_path)["link"]["bp_layered_group"] == 4


def test_cli_schedule_ckpt_rejections(tmp_path, monkeypatch):
    cut_sweeps(monkeypatch)
    edge_only = str(tmp_path / "edge.npz")
    z = np.load(K5)
    np.savez(edge_only, **{k: z[k] for k in z.files if k.startswith("w_")})
    with pytest.raises(SystemExit, match="expected a train-minsum "
                                         "checkpoint with ms_alpha/ms_beta"):
        cli_main(["sweep", "--schedule-ckpt", edge_only, "--device", "cpu",
                  "--out", str(tmp_path)])
    # JAX's behaviour: the same ms arrays frozen and in the weights raise
    with pytest.raises(ValueError, match="pass tuple alpha/beta OR "
                                         "ms_alpha/ms_beta weights"):
        cli_main(["sweep", "--code", "wifi1944", "--method", "min-sum",
                  "--clamp", "0", "--schedule", "layered", "--iters", "5",
                  "--schedule-ckpt", K5, "--weights-ckpt", K5,
                  "--device", "cpu", "--out", str(tmp_path)])


def test_cli_defaults_diverge_from_jax_on_six_flags():
    """Every flag the two sweeps share defaults as the JAX CLI's does (the
    six that differed until the gather backend and sum-product-ref were
    ported, ROADMAP §C, included): the reference chain, ref6432 with
    sum-product-ref-3 and clamp 20."""
    from ldpc_sims_tpu.cli.main import build_parser as jax_build_parser
    from ldpc_sims_tpu_torch.cli.main import build_parser

    ours = vars(build_parser().parse_args(["sweep"]))
    theirs = vars(jax_build_parser().parse_args(["sweep"]))
    shared = {k for k in set(ours) & set(theirs) if not callable(ours[k])}
    shared -= {"cmd"}
    differ = {"--" + k.replace("_", "-") for k in shared
              if ours[k] != theirs[k]}
    assert differ == set()
    for k in ("code", "iters", "method", "clamp", "snr", "batch",
              "weights_ckpt", "schedule_ckpt", "layered_group"):
        assert k in shared and ours[k] == theirs[k]
    assert (ours["code"], ours["method"]) == ("ref6432", "sum-product-ref")
