"""The diagnostic studies against the JAX package (CPU).

* ``quantization_noise_study`` on ref6432 at 5 dB, qbits 1 and 5, 512
  codewords (the function's default): the same record keys and histogram
  lengths as JAX's, each ``std`` and ``std_adc`` within 3% of JAX's (about
  5σ of a standard deviation over 16,384 samples; the random streams
  differ, so the values are held statistically).
* ``evaluate_joint`` with a flax ``Joint``'s params carried over by
  ``convert.joint_state_dict_from_flax``, on ``tests/test_diagnostics.py``'s
  setup at 1024 codewords: the same curve keys, and ``ber_classic``,
  ``ber_quantized`` and ``ber_joint`` within 4/√(frames in error),
  relative, of JAX's (bit errors come in frames, so a binomial σ on bits
  would be too tight).
* The reference hazards the port keeps: ``noise-study`` ignores the
  shared link flags (C12) and ``evaluate-joint``'s classic decodes ignore
  ``--method`` (C13); both subcommands run with ``--device cpu``.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import reference_6432 as jax_ref6432
from ldpc_sims_tpu.diagnostics import evaluate_joint as jax_evaluate_joint
from ldpc_sims_tpu.diagnostics import (
    quantization_noise_study as jax_noise_study,
)
from ldpc_sims_tpu.models import Joint as JaxJoint
from ldpc_sims_tpu.ops.chain import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu_torch.codes import reference_6432
from ldpc_sims_tpu_torch.convert import joint_params_to_flax
from ldpc_sims_tpu_torch.diagnostics import (
    evaluate_joint,
    quantization_noise_study,
)
from ldpc_sims_tpu_torch.models import Joint
from ldpc_sims_tpu_torch.ops.chain import LinkConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_noise_study_matches_jax():
    kw = dict(snrdb_grid=(5.0,), qbits_grid=(1, 5), clip_ratio_grid=(1.0,),
              num_codewords=512)
    ours = quantization_noise_study(0, reference_6432(), device="cpu", **kw)
    theirs = jax_noise_study(jax.random.key(0), jax_ref6432(), **kw)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in ("snrdb", "qbits", "clip_ratio"):
            assert a[k] == b[k]
        assert len(a["hist"]) == len(b["hist"]) == 41
        assert len(a["bin_edges"]) == len(b["bin_edges"]) == 42
        assert sum(a["hist"]) == sum(b["hist"]) == 512 * 32
        for k in ("std", "std_adc"):
            assert abs(a[k] - b[k]) <= 0.03 * b[k], (a["qbits"], k, a[k],
                                                     b[k])
    r1, r5 = ours
    assert r5["std"] < r1["std"] and r5["std_adc"] < r5["std"]


def test_evaluate_joint_matches_jax():
    snrs, n = (2.0, 6.0), 1024
    jmodel = JaxJoint(code_name="ref6432", iterations=2)
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 64), jnp.float32))
    theirs = jax_evaluate_joint(
        jmodel, params, jax_ref6432(),
        JaxLinkConfig(bp_iterations=2, qbits=3), snrdb_grid=snrs,
        num_codewords=n, log=None)
    ours = evaluate_joint(
        Joint(code_name="ref6432", iterations=2),
        jax.tree.map(np.asarray, params), reference_6432(),
        LinkConfig(bp_iterations=2, qbits=3), snrdb_grid=snrs,
        num_codewords=n, log=None, device="cpu")
    assert sorted(ours) == sorted(theirs)
    for tag in ("classic", "quantized", "joint"):
        for i in range(len(snrs)):
            a, b = ours[f"ber_{tag}"][i], theirs[f"ber_{tag}"][i]
            frames = 0.5 * n * (ours[f"bler_{tag}"][i]
                                + theirs[f"bler_{tag}"][i])
            if frames == 0:
                assert a == b == 0.0
                continue
            rel = abs(a - b) / (0.5 * (a + b))
            assert rel <= 4 / math.sqrt(frames), (tag, snrs[i], a, b,
                                                  frames)
    assert ours["ber_classic"][1] < ours["ber_classic"][0]
    assert ours["ber_joint"][1] >= ours["ber_classic"][1]


def _records(out: str, suffix: str):
    (path,) = [f for f in os.listdir(out) if f.endswith(suffix)]
    with open(os.path.join(out, path)) as f:
        return json.load(f)


def test_noise_study_ignores_the_shared_flags(tmp_path):
    """C12: as in the JAX CLI, --agc, --clipdb, --modulation, --iters and
    --method do not reach the study: it runs its per-symbol AGC."""
    from ldpc_sims_tpu_torch.cli.main import main as cli_main

    grid = ["--snr", "5", "--qbits-grid", "1,3", "--batch", "64",
            "--device", "cpu"]
    cli_main(["noise-study", *grid, "--out", str(tmp_path / "a")])
    cli_main(["noise-study", *grid, "--agc", "global", "--clipdb", "5",
              "--modulation", "bpsk", "--iters", "7", "--method", "min-sum",
              "--out", str(tmp_path / "b")])
    a = _records(str(tmp_path / "a"), "_noise_study.json")
    b = _records(str(tmp_path / "b"), "_noise_study.json")
    assert a == b
    direct = quantization_noise_study(
        0, reference_6432(), snrdb_grid=(5.0,), qbits_grid=(1, 3),
        num_codewords=64, agc="per-symbol", device="cpu")
    assert a == json.loads(json.dumps(direct))


def test_evaluate_joint_classic_ignores_method(tmp_path):
    """C13: evaluate-joint's classic and quantized decodes are sum-product
    whatever --method says (JAX's behaviour, kept)."""
    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.utils import save_checkpoint

    model = Joint(code_name="ref6432", iterations=2,
                  generator=torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path / "joint"),
                           {"params": joint_params_to_flax(model),
                            "opt_state": None}, {"model": "Joint"})
    curves = []
    for method in ("min-sum", "sum-product-ref"):
        out = str(tmp_path / method)
        cli_main(["evaluate-joint", "--ckpt", ckpt, "--iters", "2",
                  "--qbits", "3", "--snr", "2,6", "--batch", "128",
                  "--method", method, "--device", "cpu", "--out", out])
        curves.append(_records(out, "_joint_eval.json"))
    assert curves[0] == curves[1]
    assert {"ber_classic", "ber_quantized", "ber_joint"} <= set(curves[0])
