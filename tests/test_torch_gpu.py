"""The CUDA decode kernels against their plain version, on the card.

Every test here needs a CUDA device: each is marked ``gpu`` and skips
without one (the decision is taken in the ``cuda`` fixture, at run time).
This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_gpu.py

On one device the kernels repeat the plain version's arithmetic in the
same order, so the comparison asks for the stated tolerance and, in
practice, sees equality.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import LinkConfig, bp_decode, link_step
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll
from ldpc_sims_tpu_torch.parallel import SweepConfig, run_sweep

pytestmark = pytest.mark.gpu

SCHEDULES = os.path.join(os.path.dirname(__file__), "..", "docs",
                         "artifacts", "minsum_trained_schedules.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def trained8():
    with open(SCHEDULES) as f:
        e = json.load(f)["wifi1944"]["layered"]["8"]
    return tuple(e["alpha"]), tuple(e["beta"])


def llrs(code, batch, device, mu=2.0, seed=0):
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    x = (2.0 * cw - 1.0) * mu + rng.normal(0, math.sqrt(2 * mu), cw.shape)
    # encode_np may return a column-major array; the kernel takes rows
    x = np.ascontiguousarray(x, dtype=np.float32)
    return torch.from_numpy(x).to(device), cw


CONFIGS = {
    "flooding-20": dict(iterations=20, schedule="flooding"),
    "flooding-a-b-clamp": dict(iterations=20, schedule="flooding",
                               alpha=0.75, beta=0.1, clamp=20.0),
    "layered-trained8": dict(iterations=8, schedule="layered"),
    "layered-a-clamp": dict(iterations=10, schedule="layered", alpha=0.8,
                            clamp=8.0),
}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc1944_r56"])
def test_kernel_matches_plain_version(cuda, name, config):
    kw = dict(CONFIGS[config])
    if config == "layered-trained8":
        kw["alpha"], kw["beta"] = trained8()
    code = get_code(name)
    x, _ = llrs(code, 37, cuda)  # a batch of no special size
    post = mq.bp_qc_cuda(x, code.qc, output="posterior", **kw)
    bits = mq.bp_qc_cuda(x, code.qc, output="hard", **kw)
    ref = decode_roll(x, code.qc, output="posterior", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post, ref, rtol=1e-4, atol=1e-4)
    sure = ref.abs() > 1e-3
    assert torch.equal((post > 0)[sure], (ref > 0)[sure])
    assert bits.dtype == torch.int8
    assert torch.equal(bits, (post > 0).to(torch.int8))


def test_kernel_decodes_and_counts_launches(cuda):
    code = get_code("wifi1944")
    x, cw = llrs(code, 64, cuda, mu=4.0, seed=1)
    mq.reset_launch_counts()
    bits = bp_decode(x, code, iterations=20)  # auto → the kernel
    a, b = trained8()
    lbits = bp_decode(x, code, iterations=8, alpha=a, beta=b,
                      schedule="layered")
    assert mq.LAUNCHES == {"minsum_qc_flooding": 1, "minsum_qc_layered": 1}
    np.testing.assert_array_equal(bits.cpu().numpy(), cw)
    np.testing.assert_array_equal(lbits.cpu().numpy(), cw)
    soft = bp_decode(x, code, iterations=4, output="soft")
    assert soft.dtype == torch.float32
    assert 0 <= float(soft.min()) and float(soft.max()) <= 1


@pytest.mark.parametrize("bad, match", [
    (lambda x: x.double(), "float32"),
    (lambda x: x[:, :100], "width"),
    (lambda x: x.t().contiguous().t(), "contiguous"),
    (lambda x: x[:0], "empty batch"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad, match):
    code = get_code("wifi648")
    x, _ = llrs(code, 8, cuda)
    with pytest.raises(ValueError, match=match):
        mq.bp_qc_cuda(bad(x), code.qc, iterations=2)


def test_link_step_and_sweep_on_card(cuda):
    code = get_code("wifi1944")
    cfg = LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    out = link_step(gen, 1.5, code, cfg, 512)
    assert all(v.device.type == "cuda" for v in out.values())
    q = 0.5 * math.erfc(math.sqrt(10 ** 0.15) / math.sqrt(2))
    ber = int(out["uncoded_bit_errors"]) / (512 * 1944)
    assert abs(ber - q) < 4 * math.sqrt(q * (1 - q) / (512 * 1944))
    assert 0.4 < int(out["frame_errors"]) / 512 < 0.8
    res = run_sweep(code, cfg, SweepConfig(snrdb=(2.0,), batch_cw=512,
                                           max_info_bits=1e6), log=None)
    assert res.coded_bler[0] < 0.2 and res.frames[0] >= 1024
