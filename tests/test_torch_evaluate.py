"""The port's ``evaluate_sweep`` and ``evaluate`` CLI against the JAX
package (CPU).

The two packages draw their noise from different generators, so the
curves are held within Monte-Carlo confidence, 4σ of the difference:
BLER and uncoded BER as binomials (over frames, over bits); coded BER
over frames, a failed frame carrying the pooled mean error fraction w =
BER/BLER with a coefficient of variation of 1 (σ² = 2·BER·w/frames per
package). WMSE within 10% relative.

* ref6432 sum-product-ref-3 (the reference chain) and wifi648 min-sum-3
  with a 3-bit ADC, 2 points each;
* the NN family: a flax-initialised ``LLRestimator`` and
  ``LLRestimatorTanh`` carried across by ``llr_state_dict_from_flax``
  (the tanh model's flipped WMSE too);
* per-edge decoder ``weights=`` on every decode;
* three decodes a point on the same bits (the receiver's in
  ``link_step``, then the others), each through ``bp_decode``;
* ``evaluate --device cpu --ckpt`` on a checkpoint the JAX package
  wrote: the JAX CLI's JSON keys, a registry record with its parent.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.cli.main import main as jax_cli_main
from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.evaluate import EvalConfig as JaxEvalConfig
from ldpc_sims_tpu.evaluate import evaluate_sweep as jax_evaluate_sweep
from ldpc_sims_tpu.models import llr as jax_llr
from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu.ops.bp import init_neural_bp_weights
from ldpc_sims_tpu.utils import save_checkpoint as jax_save_checkpoint
from ldpc_sims_tpu_torch import evaluate as ev
from ldpc_sims_tpu_torch import models
from ldpc_sims_tpu_torch.cli.main import main as cli_main
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.convert import llr_state_dict_from_flax
from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
from ldpc_sims_tpu_torch.ops import LinkConfig
from ldpc_sims_tpu_torch.ops import chain


def _binomial_ok(a, b, n_a, n_b):
    p = (a * n_a + b * n_b) / (n_a + n_b)
    return abs(a - b) <= 4 * math.sqrt(p * (1 - p) * (1 / n_a + 1 / n_b))


def assert_curves_agree(ours, theirs, code, cw_ours, cw_theirs):
    assert set(ours) == set(theirs)
    assert ours["snrdb"] == theirs["snrdb"]
    for sfx in ("", "_qllr", "_nn"):
        if "coded_ber" + sfx not in ours:
            continue
        for i in range(len(ours["snrdb"])):
            ba, bb = ours["coded_bler" + sfx][i], theirs["coded_bler" + sfx][i]
            assert _binomial_ok(ba, bb, cw_ours, cw_theirs), (sfx, i, ba, bb)
            ea, eb = ours["coded_ber" + sfx][i], theirs["coded_ber" + sfx][i]
            p = (ea * cw_ours + eb * cw_theirs) / (cw_ours + cw_theirs)
            f = (ba * cw_ours + bb * cw_theirs) / (cw_ours + cw_theirs)
            w = p / f if f else 0.0
            sigma = math.sqrt(2 * p * w * (1 / cw_ours + 1 / cw_theirs))
            assert abs(ea - eb) <= 4 * sigma, (sfx, i, ea, eb, sigma)
    for i in range(len(ours["snrdb"])):
        assert _binomial_ok(ours["uncoded_ber"][i], theirs["uncoded_ber"][i],
                            cw_ours * code.n, cw_theirs * code.n)
    for key in ("wmse_qllr", "wmse_nn", "wmse_nn_flipped"):
        if key in ours:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0.1)


CASES = {
    # the reference chain: ref6432, QPSK/OFDM-32, sum-product-ref-3
    "ref6432-sprf3": ("ref6432", dict(bp_iterations=3), (2.0, 4.0), 4096),
    "wifi648-minsum3-q3": ("wifi648", dict(
        bp_iterations=3, bp_method="min-sum", clamp=None, qbits=3),
        (2.0, 3.0), 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_matches_jax(case):
    name, link, snrs, cw = CASES[case]
    theirs = jax_evaluate_sweep(
        jax_get_code(name), JaxLinkConfig(**link),
        JaxEvalConfig(snrdb=snrs, num_codewords=cw, seed=1), log=None)
    code = get_code(name)
    ours = evaluate_sweep(code, LinkConfig(**link),
                          EvalConfig(snrdb=snrs, num_codewords=cw, seed=1),
                          log=None, device="cpu")
    assert_curves_agree(ours, theirs, code, cw, cw)
    if "qbits" in link:
        assert ours["coded_ber_qllr"][1] > ours["coded_ber"][1]


@pytest.mark.parametrize("name", ["LLRestimator", "LLRestimatorTanh"])
def test_evaluate_nn_family_matches_jax(name):
    snr_feature = name != "LLRestimator"
    fmod = getattr(jax_llr, name)(32)
    params = fmod.init(jax.random.key(7),
                       jnp.zeros((2, 64 + snr_feature), jnp.float32))
    link = dict(bp_iterations=3)
    cw, snrs = 4096, (3.0,)
    kw = dict(snrdb=snrs, num_codewords=cw, with_snr_feature=snr_feature,
              tanh_model=name == "LLRestimatorTanh", seed=2)
    theirs = jax_evaluate_sweep(jax_get_code("ref6432"),
                                JaxLinkConfig(**link), JaxEvalConfig(**kw),
                                model=fmod, params=params, log=None)
    model = getattr(models, name)(32)
    model.load_state_dict(llr_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    code = get_code("ref6432")
    ours = evaluate_sweep(code, LinkConfig(**link), EvalConfig(**kw),
                          model=model, log=None, device="cpu")
    assert_curves_agree(ours, theirs, code, cw, cw)
    assert ("wmse_nn_flipped" in ours) == (name == "LLRestimatorTanh")


def test_evaluate_weights_match_jax():
    rng = np.random.default_rng(3)
    ones = init_neural_bp_weights(jax_get_code("wifi648"), 3)
    w = {k: rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
         for k, v in ones.items()}
    link = dict(bp_iterations=3, bp_method="min-sum", clamp=None)
    ec = dict(snrdb=(2.5,), num_codewords=1024, seed=4)
    theirs = jax_evaluate_sweep(jax_get_code("wifi648"),
                                JaxLinkConfig(**link), JaxEvalConfig(**ec),
                                weights=w, log=None)
    code = get_code("wifi648")
    ours = evaluate_sweep(code, LinkConfig(**link), EvalConfig(**ec),
                          weights=w, log=None, device="cpu")
    assert_curves_agree(ours, theirs, code, 1024, 1024)
    # the weights reach the decodes: zeroed LLR weights destroy them
    broken = evaluate_sweep(
        code, LinkConfig(**link), EvalConfig(**ec),
        weights={k: (np.zeros_like(v) if k.startswith("w_llr") else v)
                 for k, v in w.items()}, log=None, device="cpu")
    assert broken["coded_ber"][0] > 0.2 > 5 * ours["coded_ber"][0]


def test_three_decodes_a_point_on_the_same_bits(monkeypatch):
    calls = []

    def counting(decode):
        def run(llrs, *a, **kw):
            calls.append(llrs.shape)
            return decode(llrs, *a, **kw)
        return run

    monkeypatch.setattr(chain, "bp_decode", counting(chain.bp_decode))
    monkeypatch.setattr(ev, "bp_decode", counting(ev.bp_decode))
    code = get_code("wifi648")
    model = models.LLRestimator(32, generator=torch.Generator().manual_seed(0))
    link = LinkConfig(bp_iterations=2, bp_method="min-sum", clamp=None,
                      qbits=3)
    curves = evaluate_sweep(code, link, EvalConfig(snrdb=(2.0, 3.0),
                                                   num_codewords=64),
                            model=model, log=None, device="cpu")
    assert calls == [(64, 648)] * 6
    assert {"coded_ber", "coded_ber_qllr", "coded_ber_nn", "wmse_qllr",
            "wmse_nn"} <= set(curves)


def test_evaluate_cli_on_jax_checkpoint(tmp_path):
    fmod = jax_llr.LLRestimatorWithSNR(32)
    params = fmod.init(jax.random.key(1), jnp.zeros((2, 65), jnp.float32))
    ckpt = str(tmp_path / "llr_snr")
    jax_save_checkpoint(ckpt, {"params": params, "opt_state": None},
                        {"model": "LLRestimatorWithSNR"})
    argv = ["evaluate", "--code", "ref6432", "--snr", "3", "--batch", "256",
            "--ckpt", ckpt, "--qbits", "3"]
    outs = {}
    for tag, run, extra in (("jax", jax_cli_main, []),
                            ("port", cli_main, ["--device", "cpu"])):
        out = str(tmp_path / tag)
        os.makedirs(out)
        # a training run that names the checkpoint: the evaluate record's
        # parent
        with open(os.path.join(out, "registry.jsonl"), "w") as f:
            f.write(json.dumps({"id": "train-1", "kind": "train-llr",
                                "ckpt": ckpt}) + "\n")
        run(argv + extra + ["--out", out])
        files = sorted(os.listdir(out))
        (curves,) = [f for f in files if f.endswith("_eval.json")]
        with open(os.path.join(out, curves)) as f:
            data = json.load(f)
        with open(os.path.join(out, "registry.jsonl")) as f:
            runs = [json.loads(line) for line in f]
        outs[tag] = (data, runs)
    (jdata, jruns), (pdata, pruns) = outs["jax"], outs["port"]
    assert set(pdata) == set(jdata)
    assert {"coded_ber_nn", "wmse_nn", "coded_ber_qllr"} <= set(pdata)
    assert pdata["code"] == jdata["code"] == "ref6432"
    assert [r["kind"] for r in pruns] == [r["kind"] for r in jruns]
    assert set(pruns[-1]) == set(jruns[-1])
    assert pruns[-1]["parent"] == jruns[-1]["parent"] == "train-1"
    assert pruns[-1]["ckpt"] == ckpt
    assert all(np.isfinite(v).all() for k, v in pdata.items()
               if k != "code")
