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
from ldpc_sims_tpu_torch.codes.library import QcStructure
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


def mixed_llrs(code, batch, device, seed=0):
    """LLRs whose mean grows from 1 to 12 over the rows: some codewords
    pass at entry, some converge after a few iterations, some never."""
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    mu = np.linspace(1.0, 12.0, batch)[:, None]
    x = (2.0 * cw - 1.0) * mu + rng.normal(0, 1, cw.shape) * np.sqrt(2 * mu)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


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


CODES = ["wifi648", "wifi1944", "qc1944_r56"]


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", CODES)
def test_hard_unsat_matches_plain_version(cuda, name, schedule):
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda)
    kw = dict(iterations=4, schedule=schedule, output="hard_unsat")
    bits, unsat = mq.bp_qc_cuda(x, code.qc, **kw)
    ref_bits, ref_unsat = decode_roll(x, code.qc, **kw)
    assert torch.equal(bits, ref_bits) and torch.equal(unsat, ref_unsat)
    H = torch.from_numpy(code.H.astype(np.float32)).to(cuda)
    ext = torch.remainder(bits.float() @ H.T, 2).sum(1).to(torch.int32)
    assert torch.equal(unsat, ext)
    assert (unsat == 0).any() and (unsat > 0).any()


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", CODES)
def test_early_stop_kernel_matches_plain_version(cuda, name, schedule, K):
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda, seed=2)
    kw = dict(iterations=12, schedule=schedule, output="hard_iters",
              early_stop=True, es_check_every=K)
    mq.reset_launch_counts()
    bits, iters = mq.bp_qc_cuda(x, code.qc, **kw)
    assert mq.LAUNCHES[f"minsum_qc_{schedule}_es"] == 1
    ref_bits, ref_iters = decode_roll(x, code.qc, **kw)
    assert torch.equal(iters, ref_iters) and torch.equal(bits, ref_bits)
    assert len(set(iters.tolist())) > 1  # several exits exercised


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name", CODES)
def test_done_in_skips_flagged_codewords(cuda, name, early_stop):
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda, seed=3)
    done = torch.arange(37, device=cuda) % 3 == 0
    out = torch.full(x.shape, 7, dtype=torch.int8, device=cuda)
    kw = dict(iterations=8, schedule="layered", early_stop=early_stop,
              output="hard_iters" if early_stop else "hard")
    got = mq.bp_qc_cuda(x, code.qc, done_in=done, out=out, **kw)
    want = decode_roll(x, code.qc, done_in=done, **kw)
    if early_stop:
        assert torch.equal(got[1], want[1])
        assert (got[1][done] == 0).all()
        got, want = got[0], want[0]
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got[~done], want[~done])
    assert (got[done] == 7).all()


@pytest.mark.parametrize("name", CODES)
def test_drivers_match_plain_version(cuda, name):
    """Both drivers on the card equal the same drivers on the CPU, where
    they run the plain version."""
    code = get_code(name)
    x = mixed_llrs(code, 64, cuda, seed=4)
    for driver, kw in (
        (mq.bp_qc_requeue, dict(iterations=12, probe_iters=4,
                                es_check_every=2, schedule="layered")),
        (mq.bp_qc_probe_requeue, dict(iterations=12, probe_iters=3)),
    ):
        bits, iters = driver(x, code.qc, output="hard_iters", **kw)
        ref_bits, ref_iters = driver(x.cpu(), code.qc, output="hard_iters",
                                     **kw)
        assert torch.equal(bits.cpu(), ref_bits)
        assert torch.equal(iters.cpu(), ref_iters)


def test_probe_overflow_on_card(cuda):
    code = get_code("wifi648")
    x, _ = llrs(code, 512, cuda, mu=0.3, seed=5)
    bits, iters = mq.bp_qc_probe_requeue(x, code.qc, 8, probe_iters=2,
                                         output="hard_iters")
    assert (iters == 10).all()
    assert torch.equal(bits, decode_roll(x, code.qc, iterations=8,
                                         schedule="layered"))


def test_kernel_decodes_and_counts_launches(cuda):
    code = get_code("wifi1944")
    x, cw = llrs(code, 64, cuda, mu=4.0, seed=1)
    mq.reset_launch_counts()
    bits = bp_decode(x, code, iterations=20)  # auto → the kernel
    a, b = trained8()
    lbits = bp_decode(x, code, iterations=8, alpha=a, beta=b,
                      schedule="layered")
    assert {k: v for k, v in mq.LAUNCHES.items() if v} == {
        "minsum_qc_flooding": 1, "minsum_qc_layered": 1}
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


def test_es_auto_sweep_and_qam16_on_card(cuda, tmp_path):
    code = get_code("wifi1944")
    cfg = LinkConfig(modulation="qam16", ofdm_size=64, bp_iterations=20,
                     bp_method="min-sum", clamp=None, bp_schedule="layered",
                     early_stop=True, es_mode="auto")
    path = str(tmp_path / "m.json")
    mq.reset_launch_counts()
    res = run_sweep(code, cfg, SweepConfig(snrdb=(8.0,), batch_cw=512,
                                           max_info_bits=2e6),
                    manifest_path=path, log=None)
    assert mq.LAUNCHES["minsum_qc_layered"] >= 4
    with open(path) as f:
        assert json.load(f)["points"]["8"]["es_auto_mode"] in ("fixed",
                                                              "probe")
    assert res.coded_ber[0] < res.uncoded_ber[0]


# the new check rules and the message quantization: (method, msg_qbits)
RULES = [("sum-product", None), ("min-sum", 4), ("sum-product", 3)]


def saturated(x):
    """Row 0 at |LLR| = 60 with its own signs."""
    x = x.clone()
    x[0] = torch.where(x[0] > 0, 60.0, -60.0)
    return x


@pytest.mark.parametrize("method, qbits", RULES)
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_new_rules_match_plain_version(cuda, name, schedule, method, qbits):
    """Sum-product and quantized forms, fixed and hard_unsat: posteriors
    within 1e-4, bits and counts equal, the saturated row finite."""
    code = get_code(name)
    x = saturated(mixed_llrs(code, 37, cuda, seed=6))
    kw = dict(iterations=6, schedule=schedule, method=method,
              msg_qbits=qbits)
    mq.reset_launch_counts()
    post = mq.bp_qc_cuda(x, code.qc, output="posterior", **kw)
    bits, unsat = mq.bp_qc_cuda(x, code.qc, output="hard_unsat", **kw)
    assert mq.LAUNCHES[mq.KERNELS[method, schedule, False,
                                  qbits is not None]] == 2
    ref = decode_roll(x, code.qc, output="posterior", **kw)
    ref_bits, ref_unsat = decode_roll(x, code.qc, output="hard_unsat", **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(post).all()
    torch.testing.assert_close(post, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(bits, ref_bits) and torch.equal(unsat, ref_unsat)


@pytest.mark.parametrize("method, qbits", RULES)
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_new_rules_early_stop_and_done_in(cuda, name, schedule, method,
                                          qbits):
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda, seed=7)
    kw = dict(iterations=12, schedule=schedule, method=method,
              msg_qbits=qbits, early_stop=True, es_check_every=2,
              output="hard_iters")
    bits, iters = mq.bp_qc_cuda(x, code.qc, **kw)
    ref_bits, ref_iters = decode_roll(x, code.qc, **kw)
    assert torch.equal(iters, ref_iters) and torch.equal(bits, ref_bits)
    done = torch.arange(37, device=cuda) % 3 == 0
    out = torch.full(x.shape, 7, dtype=torch.int8, device=cuda)
    kw = dict(iterations=8, schedule=schedule, method=method,
              msg_qbits=qbits)
    mq.bp_qc_cuda(x, code.qc, done_in=done, out=out, **kw)
    want = decode_roll(x, code.qc, done_in=done, **kw)
    assert torch.equal(out[~done], want[~done]) and (out[done] == 7).all()


@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_sumproduct_drivers_match_plain_passes(cuda, name):
    """Both drivers with sum-product, against their passes in the plain
    version on the card (the CPU's transcendentals round differently)."""
    code, qc = get_code(name), get_code(name).qc
    x = mixed_llrs(code, 64, cuda, seed=8)
    sp = dict(method="sum-product", schedule="layered")
    bits, iters = mq.bp_qc_requeue(x, qc, 12, probe_iters=4,
                                   es_check_every=2, output="hard_iters",
                                   **sp)
    es = dict(early_stop=True, es_check_every=2, output="hard_iters", **sp)
    b1, i1 = decode_roll(x, qc, iterations=4, **es)
    b2, i2 = decode_roll(x, qc, iterations=12, **es)
    done = i1 < 4
    assert torch.equal(iters, torch.where(done, i1, 4 + i2))
    assert torch.equal(bits, torch.where(done[:, None], b1, b2))
    bits, iters = mq.bp_qc_probe_requeue(x, qc, 12, probe_iters=3,
                                         output="hard_iters", **sp)
    b1, u = decode_roll(x, qc, iterations=3, output="hard_unsat", **sp)
    b2 = decode_roll(x, qc, iterations=12, **sp)
    keep = (u == 0) & (64 - int((u == 0).sum()) <= mq.probe_capacity(64))
    assert torch.equal(bits, torch.where(keep[:, None], b1, b2))
    assert torch.equal(iters, torch.where(keep, 3, 15).to(torch.int32))


def test_new_rules_count_launches_and_guard_degree(cuda):
    code = get_code("wifi648")
    x, cw = llrs(code, 64, cuda, mu=5.0, seed=9)
    mq.reset_launch_counts()
    sp = bp_decode(x, code, iterations=10, method="sum-product",
                   schedule="layered")
    q = bp_decode(x, code, iterations=10, msg_qbits=4)
    es = bp_decode(x, code, iterations=10, method="sum-product",
                   early_stop=True, es_mode="probe", schedule="layered")
    assert {k: v for k, v in mq.LAUNCHES.items() if v} == {
        "sumproduct_qc_layered": 3, "minsum_qc_flooding_msgq": 1}
    for bits in (sp, q, es):
        np.testing.assert_array_equal(bits.cpu().numpy(), cw)
    wide = QcStructure(z=4, base=(tuple(range(33)),))
    with pytest.raises(ValueError, match="at most 32"):
        mq.bp_qc_cuda(torch.zeros((2, 132), device=cuda), wide, 2,
                      method="sum-product")


def random_edge_weights(code, iterations, seed=0):
    """Edge-flavor weights drawn uniformly from [0.7, 1.3]."""
    rng = np.random.default_rng(seed)
    g = code.graph
    shapes = {"w_msg": (iterations, g.n_vars, g.dv),
              "w_llr": (iterations, g.n_vars),
              "w_msg_final": (g.n_vars, g.dv), "w_llr_final": (g.n_vars,)}
    return {k: rng.uniform(0.7, 1.3, s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("qbits", [None, 4])
@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_weighted_kernels_match_plain_version(cuda, name, schedule, method,
                                              qbits):
    """The eight _w entry points: posteriors within 1e-4 (equal in
    practice), bits and counts equal, one launch each."""
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda, seed=10)
    w = random_edge_weights(code, 5, seed=11)
    kw = dict(iterations=5, schedule=schedule, method=method,
              msg_qbits=qbits, weights=w)
    mq.reset_launch_counts()
    post = mq.bp_qc_cuda(x, code.qc, output="posterior", **kw)
    bits, unsat = mq.bp_qc_cuda(x, code.qc, output="hard_unsat", **kw)
    assert mq.LAUNCHES[mq.KERNELS_W[method, schedule,
                                    qbits is not None]] == 2
    ref = decode_roll(x, code.qc, output="posterior", **kw)
    ref_bits, ref_unsat = decode_roll(x, code.qc, output="hard_unsat", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(bits, ref_bits) and torch.equal(unsat, ref_unsat)


def test_weighted_kernel_with_trained_k6_and_ms_table(cuda):
    """The committed K6 decoder through bp_decode: its ms arrays become
    the kernel's α/β table, equal to the same arrays frozen to tuples."""
    from ldpc_sims_tpu_torch.ops import pack_decoder_weights
    from ldpc_sims_tpu_torch.utils import load_decoder_weights

    code = get_code("wifi1944")
    w = load_decoder_weights(os.path.join(os.path.dirname(SCHEDULES),
                                          "edge_layered_1944_K6.npz"))
    x, cw = llrs(code, 64, cuda, mu=2.0, seed=12)
    kw = dict(iterations=6, schedule="layered", output="posterior")
    mq.reset_launch_counts()
    got = bp_decode(x, code, weights=w, **kw)
    packed = bp_decode(x, code, weights=pack_decoder_weights(
        w, code, 6, cuda), **kw)
    assert mq.LAUNCHES["minsum_qc_layered_w"] == 2
    edge = {k: v for k, v in w.items() if k.startswith("w_")}
    a = tuple(float(v) for v in w["ms_alpha"])
    b = tuple(float(v) for v in w["ms_beta"])
    ref = decode_roll(x, code.qc, alpha=a, beta=b, weights=edge, **kw)
    assert torch.equal(got, packed)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # weights that need a gradient: auto decodes on the plain version and
    # keeps the graph, launching no kernel; backend='cuda' refuses them
    grad = {k: torch.as_tensor(v, device=cuda).requires_grad_()
            for k, v in edge.items()}
    mq.reset_launch_counts()
    post = bp_decode(x, code, weights=grad, **kw)
    post.sum().backward()
    assert sum(mq.LAUNCHES.values()) == 0
    assert all(torch.isfinite(v.grad).all() for v in grad.values())
    torch.testing.assert_close(post.detach(), decode_roll(
        x, code.qc, weights=edge, **kw), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="carry no gradient"):
        bp_decode(x, code, weights=grad, backend="cuda", **kw)


@pytest.mark.parametrize("group", [2, 3, 12])
@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_group_serial_matches_plain_version(cuda, name, method, group):
    code = get_code(name)
    x = mixed_llrs(code, 37, cuda, seed=13)
    kw = dict(iterations=6, schedule="layered", method=method,
              layered_group=group)
    mq.reset_launch_counts()
    post = mq.bp_qc_cuda(x, code.qc, output="posterior", **kw)
    bits, iters = mq.bp_qc_cuda(x, code.qc, early_stop=True,
                                output="hard_iters", **kw)
    assert mq.LAUNCHES[mq.KERNELS[method, "layered", False, False]] == 1
    assert mq.LAUNCHES[mq.KERNELS[method, "layered", True, False]] == 1
    ref = decode_roll(x, code.qc, output="posterior", **kw)
    ref_bits, ref_iters = decode_roll(x, code.qc, early_stop=True,
                                      output="hard_iters", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(bits, ref_bits) and torch.equal(iters, ref_iters)
    w = random_edge_weights(code, 6, seed=14)
    wpost = mq.bp_qc_cuda(x, code.qc, output="posterior", weights=w, **kw)
    wref = decode_roll(x, code.qc, output="posterior", weights=w, **kw)
    torch.testing.assert_close(wpost, wref, rtol=1e-4, atol=1e-4)


def test_group_serial_endpoints_on_card(cuda):
    """G = 1 is the serial-C kernel bit for bit; G = mb is flooding
    within 1e-4."""
    code = get_code("wifi1944")
    x = mixed_llrs(code, 37, cuda, seed=15)
    kw = dict(iterations=6, output="posterior")
    g1 = mq.bp_qc_cuda(x, code.qc, schedule="layered", layered_group=1, **kw)
    lay = mq.bp_qc_cuda(x, code.qc, schedule="layered", **kw)
    assert torch.equal(g1, lay)
    gmb = mq.bp_qc_cuda(x, code.qc, schedule="layered",
                        layered_group=code.qc.mb, **kw)
    flood = mq.bp_qc_cuda(x, code.qc, **kw)
    torch.testing.assert_close(gmb, flood, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("group", [2, 4])
def test_group_serial_on_the_largest_code(cuda, group):
    """qc12288 (z = 512, 109 KB of compressed state a CTA): a group's
    scratch holds only its shared planes, so G = 4 takes 144 KB; G = mb
    (all 61 planes shared, 230 KB) would not fit, and the wrapper says so
    before the launch."""
    code = get_code("qc12288_r12")
    gen = torch.Generator().manual_seed(16)
    x = (2.0 + 2.0 * torch.randn((8, code.n), generator=gen)).to(cuda)
    kw = dict(iterations=4, schedule="layered", layered_group=group,
              output="posterior")
    post = mq.bp_qc_cuda(x, code.qc, **kw)
    ref = decode_roll(x, code.qc, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="shared memory"):
        mq.bp_qc_cuda(x, code.qc, **dict(kw, layered_group=12))


STORAGE = {"bf16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("method, qbits", [("min-sum", None), *RULES])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("dtype", STORAGE)
@pytest.mark.parametrize("name", ["wifi648", "wifi1944"])
def test_storage_forms_match_plain_version(cuda, name, dtype, schedule,
                                           method, qbits):
    """Every form at bf16 and int8 storage, exactly equal to the plain
    version: posterior, bits and counts, early stop, done_in, the weighted
    form and, layered, G = 3; the saturated row included."""
    code, qc = get_code(name), get_code(name).qc
    x = saturated(mixed_llrs(code, 37, cuda, seed=11))
    st = dict(schedule=schedule, method=method, msg_qbits=qbits,
              dtype=STORAGE[dtype], msg_qclip=24.0 if qbits is None else 20.)
    mq.reset_launch_counts()
    for kw in (dict(iterations=6, output="posterior"),
               dict(iterations=6, output="hard_unsat"),
               dict(iterations=12, early_stop=True, es_check_every=2,
                    output="hard_iters"),
               dict(iterations=4, output="posterior",
                    weights=random_edge_weights(code, 4, seed=12)),
               *([dict(iterations=6, output="posterior", layered_group=3)]
                 if schedule == "layered" else [])):
        got = mq.bp_qc_cuda(x, qc, **st, **kw)
        want = decode_roll(x, qc, **st, **kw)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        assert all(torch.equal(a, b) for a, b in pairs), kw
    name_ = mq.kernel_name(method, schedule, False, qbits is not None,
                           dtype=STORAGE[dtype])
    assert name_.endswith("_bf16" if dtype == "bf16" else "_i8")
    assert mq.LAUNCHES[name_] == 2 + (schedule == "layered")
    done = torch.arange(37, device=cuda) % 3 == 0
    out = torch.full(x.shape, 7, dtype=torch.int8, device=cuda)
    mq.bp_qc_cuda(x, qc, iterations=6, done_in=done, out=out, **st)
    want = decode_roll(x, qc, iterations=6, done_in=done, **st)
    assert torch.equal(out[~done], want[~done]) and (out[done] == 7).all()


@pytest.mark.parametrize("dtype", STORAGE)
def test_storage_drivers_match_plain_passes(cuda, dtype):
    code, qc = get_code("wifi1944"), get_code("wifi1944").qc
    x = mixed_llrs(code, 64, cuda, seed=13)
    st = dict(schedule="layered", dtype=STORAGE[dtype], msg_qclip=24.0)
    bits, iters = mq.bp_qc_requeue(x, qc, 12, probe_iters=4,
                                   es_check_every=2, output="hard_iters",
                                   **st)
    es = dict(early_stop=True, es_check_every=2, output="hard_iters", **st)
    b1, i1 = decode_roll(x, qc, iterations=4, **es)
    b2, i2 = decode_roll(x, qc, iterations=12, **es)
    done = i1 < 4
    assert torch.equal(iters, torch.where(done, i1, 4 + i2))
    assert torch.equal(bits, torch.where(done[:, None], b1, b2))
    bits = mq.bp_qc_probe_requeue(x, qc, 12, probe_iters=3, **st)
    b1, u = decode_roll(x, qc, iterations=3, output="hard_unsat", **st)
    b2 = decode_roll(x, qc, iterations=12, **st)
    keep = (u == 0) & (64 - int((u == 0).sum()) <= mq.probe_capacity(64))
    assert torch.equal(bits, torch.where(keep[:, None], b1, b2))


@pytest.mark.parametrize("dtype", ["f32", *STORAGE])
def test_storage_on_the_largest_code(cuda, dtype):
    """qc12288 layered at each storage type (175, 88 and 81 KB a
    codeword), exactly the plain version, and bf16 and int8 decode as
    well as f32 on easy LLRs."""
    code = get_code("qc12288_r12")
    x, cw = llrs(code, 8, cuda, mu=4.0, seed=14)
    dt = STORAGE.get(dtype, torch.float32)
    kw = dict(iterations=10, schedule="layered", dtype=dt, msg_qclip=24.0)
    post = mq.bp_qc_cuda(x, code.qc, output="posterior", **kw)
    assert torch.equal(post, decode_roll(x, code.qc, output="posterior",
                                         **kw))
    np.testing.assert_array_equal((post > 0).to(torch.int8).cpu().numpy(),
                                  cw)


def test_storage_shared_memory_limit(cuda):
    """qc12288 at G = mb: 230 KB at f32 raises before the launch, bf16's
    182 KB launches and equals the plain version."""
    code = get_code("qc12288_r12")
    x, _ = llrs(code, 4, cuda, seed=15)
    kw = dict(iterations=2, schedule="layered", layered_group=12,
              output="posterior")
    with pytest.raises(ValueError, match="shared memory"):
        mq.bp_qc_cuda(x, code.qc, **kw)
    post = mq.bp_qc_cuda(x, code.qc, dtype=torch.bfloat16, **kw)
    assert torch.equal(post, decode_roll(x, code.qc, dtype=torch.bfloat16,
                                         **kw))


def test_threads_on_card(cuda):
    """The flooding CTA size changes nothing but the time; bad sizes raise
    before the launch."""
    code = get_code("wifi1944")
    x, _ = llrs(code, 16, cuda, seed=16)
    ref = mq.bp_qc_cuda(x, code.qc, iterations=6, output="posterior")
    for th in (32, 128, 512, 1024):
        assert torch.equal(mq.bp_qc_cuda(x, code.qc, iterations=6,
                                         output="posterior", threads=th),
                           ref)
    for bad in (0, 48, 1056):
        with pytest.raises(ValueError, match="multiple of 32"):
            mq.bp_qc_cuda(x, code.qc, iterations=6, threads=bad)


def test_bigcode_and_tuner_end_to_end(cuda, tmp_path):
    """``python -m ldpc_sims_tpu_torch.examples.bigcode`` and ``python -m
    ldpc_sims_tpu_torch.kernels.tune`` at a small batch."""
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    out = tmp_path / "big.json"
    env = dict(os.environ, BIG_CODES="qc8448_r12", BIG_BATCH="256",
               BIG_PIPE="2", BIG_SNRS="2.25", BIG_OUT=str(out),
               TUNE_CODE="wifi648", TUNE_BATCH="512", TUNE_ITERS="4",
               TUNE_THREADS="128,256", TUNE_SCHEDULES="flooding,layered")
    subprocess.run([sys.executable, "-m",
                    "ldpc_sims_tpu_torch.examples.bigcode"], cwd=root,
                   env=env, check=True, timeout=600)
    rec = json.loads(out.read_text())
    ent = rec["codes"]["qc8448_r12"]
    for label in ("flooding-20 f32", "layered-10 f32", "layered-10 bf16",
                  "layered-10 int8"):
        assert ent[label]["info_bits_per_s"] > 0
        assert 0 <= ent["ber"]["2.25"][label]["ber"] < 0.05
    res = subprocess.run([sys.executable, "-m",
                          "ldpc_sims_tpu_torch.kernels.tune"], cwd=root,
                         env=env, check=True, timeout=600,
                         capture_output=True, text=True)
    lines = [json.loads(v) for v in res.stdout.splitlines()]
    assert len(lines) == 2 * 3 + 3  # flooding × 2 sizes, layered, × 3
    assert all("ms_per_step" in v for v in lines), lines


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("name", ["wifi648", "qc8448_r12", "qc1944_r23"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_serial_c_minsum_integer_llrs(cuda, name, dtype, schedule):
    """Serial-C and flooding min-sum on integer LLRs (tied minima, zero
    magnitudes, β above the minimum) equal the plain version: on the
    compressed check state (wifi648, rows of degree 7-8 at the state's
    8-slot limit; qc8448_r12) and on its wide word beyond that limit
    (qc1944_r23, degree 8-9: the _cw kernels)."""
    code = get_code(name)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x = torch.randint(-3, 4, (64, code.n), generator=gen,
                      device=cuda).float()
    kw = dict(iterations=4, schedule=schedule, dtype=dtype, msg_qclip=4.0,
              alpha=(1.0, 0.75, 0.5, 1.0), beta=(0.0, 1.0, 2.5, 0.5),
              clamp=2.0, output="posterior")
    assert mq.compressed_state(code.qc, schedule=schedule)
    assert mq.design(code.qc, "min-sum", schedule) == (
        "compressed-wide" if name == "qc1944_r23" else "compressed")
    mq.reset_launch_counts()
    assert torch.equal(mq.bp_qc_cuda(x, code.qc, **kw),
                       decode_roll(x, code.qc, **kw))
    assert mq.ENTRY_LAUNCHES == {
        mq.entry_point(code.qc, "min-sum", schedule, dtype=dtype): 1}


def code_of(name):
    """A library code, or ``degree-10``: qc1944_r34's base with the
    circulant of its second block row's first column dropped (a row of
    degree 10, which no body of the wide rows has: the full-message
    kernels, chip_smoke.py's degree10_code)."""
    if name != "degree-10":
        return get_code(name)
    from ldpc_sims_tpu_torch.codes.qc_construct import qc_from_base

    base = [list(r) for r in get_code("qc1944_r34").qc.base]
    base[1][0] = -1
    return qc_from_base(base, 81, "qc1944_r34_d10")


# the entry points' design suffix of the sum-product and group-serial
# kernels by code: the slots in registers and group-serial within the
# narrow limits, the same on the wide rows, the full messages
SUFFIX = {"qc1944_r23": ("_rw", "_gw"), "degree-10": ("", "")}


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc8448_r12",
                                  "qc1944_r23", "degree-10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_sumproduct_registers_match_plain_version(cuda, name, dtype,
                                                  schedule):
    """Sum-product with a check's slots in registers (the _sr entry points)
    on a saturated row and the channel's regimes: fixed with its
    unsatisfied-check count, early stop at K = 2, per-edge weights, each
    with and without 4-bit messages, exactly equal to the plain version;
    qc1944_r23 (rows of degree 8-9) serial-C on the wide rows' _rw entry
    points and flooding on the full-message kernels, the degree-10 code on
    the full-message kernels."""
    code = code_of(name)
    x = saturated(mixed_llrs(code, 40, cuda, seed=11))
    entry = mq.entry_point(code.qc, "sum-product", schedule, dtype=dtype)
    sfx = SUFFIX.get(name, ("_sr",))[0]
    if sfx == "_rw" and schedule == "flooding":
        sfx = ""
    assert entry == (mq.kernel_name("sum-product", schedule) + sfx
                     + mq.STORAGE[dtype][1])
    w = random_edge_weights(code, 3, seed=12)
    mq.reset_launch_counts()
    for qb in (None, 4):
        kw = dict(schedule=schedule, method="sum-product", dtype=dtype,
                  msg_qbits=qb, msg_qclip=20.0)
        for extra in (dict(iterations=6, output="posterior"),
                      dict(iterations=6, output="hard_unsat"),
                      dict(iterations=6, early_stop=True, es_check_every=2,
                           output="hard_iters"),
                      dict(iterations=3, weights=w, output="posterior")):
            got = mq.bp_qc_cuda(x, code.qc, **kw, **extra)
            want = decode_roll(x, code.qc, **kw, **extra)
            for g, r in (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)]):
                assert torch.equal(g, r), (qb, extra.get("output"))
    # per message width: the fixed entry point twice, early stop and
    # weighted once each
    assert mq.ENTRY_LAUNCHES == {
        mq.entry_point(code.qc, "sum-product", schedule, es, qb is not None,
                       weighted, dtype): n
        for qb in (None, 4)
        for es, weighted, n in ((False, False, 2), (True, False, 1),
                                (False, True, 1))}


def test_sumproduct_registers_in_the_wifi648_sweep_preset(cuda):
    """The preset's decode (layered-20 sum-product, es auto's two modes)
    launches the _sr kernel, and a group-serial decode the _gs one."""
    code = get_code("wifi648")
    x, cw = llrs(code, 256, cuda, mu=5.0, seed=13)
    mq.reset_launch_counts()
    for mode in ("probe", "requeue"):
        bits = bp_decode(x, code, iterations=20, method="sum-product",
                         schedule="layered", early_stop=True, es_mode=mode)
        np.testing.assert_array_equal(bits.cpu().numpy(), cw)
    bp_decode(x, code, iterations=20, method="sum-product",
              schedule="layered", layered_group=3)
    assert mq.ENTRY_LAUNCHES == {"sumproduct_qc_layered_sr": 2,
                                 "sumproduct_qc_layered_es_sr": 2,
                                 "sumproduct_qc_layered_gs": 1}


@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc1944_r23",
                                  "degree-10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_group_serial_kernels_exactly_equal(cuda, name, dtype, method):
    """The group-serial kernels (_gs) at G = 2, 3, 4 and mb: fixed with its
    unsatisfied-check count, early stop at K = 2, per-edge weights, each
    with and without 3-bit messages, exactly equal to the plain version on
    integer LLRs (min-sum: ties, zero magnitudes, β above the minimum) or
    channel LLRs with saturated rows (sum-product); qc1944_r23 (rows of
    degree 8-9) on the wide rows' _gw kernels (its G = 1 on the _cw and
    _rw kernels), the degree-10 code on the full-message kernels."""
    code = code_of(name)
    if method == "min-sum":
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        x = torch.randint(-3, 4, (64, code.n), generator=gen,
                          device=cuda).float()
        rule = dict(alpha=(1.0, 0.75, 0.5, 1.0), beta=(0.0, 1.0, 2.5, 0.5),
                    clamp=2.0, msg_qclip=4.0)
    else:
        x = saturated(mixed_llrs(code, 64, cuda, seed=6))
        rule = dict(msg_qclip=20.0)
    w = random_edge_weights(code, 4, seed=7)
    for G in (2, 3, 4, code.qc.mb):
        mq.reset_launch_counts()
        for qb in (None, 3):
            kw = dict(rule, iterations=4, schedule="layered", method=method,
                      dtype=dtype, msg_qbits=qb, layered_group=G)
            for extra in (dict(output="posterior"), dict(output="hard_unsat"),
                          dict(early_stop=True, es_check_every=2,
                               output="hard_iters"),
                          dict(weights=w, output="posterior")):
                got = mq.bp_qc_cuda(x, code.qc, **kw, **extra)
                want = decode_roll(x, code.qc, **kw, **extra)
                for g, r in (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)]):
                    assert torch.equal(g, r), (G, qb, extra.get("output"))
        sfx = SUFFIX.get(name, (None, "_gs"))[1]
        forms = {*mq.KERNELS.values(), *mq.KERNELS_W.values()}
        for e in mq.ENTRY_LAUNCHES:
            base = e.removesuffix(mq.STORAGE[dtype][1])
            assert "_qc_layered" in e and base.endswith(sfx)
            assert base[:len(base) - len(sfx)] in forms
        assert sum(mq.ENTRY_LAUNCHES.values()) == 8
    rows = {"qc1944_r23": "-wide", "degree-10": None}.get(name, "")
    want = "full" if rows is None else (
        ("compressed" if method == "min-sum" else "registers") + rows)
    assert mq.design(code.qc, method, "layered", 1) == want


WIDE_CODES = ["qc648_r23", "qc648_r34", "qc648_r56", "qc1944_r56"]


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("name", WIDE_CODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_wide_state_kernels_exactly_equal(cuda, name, dtype, schedule):
    """The min-sum kernels on the compressed state's wide word (_cw: rows
    of degree 8-9, 11-12 and 17-18) on integer LLRs (ties, zero
    magnitudes, β above the minimum): fixed with its unsatisfied-check
    count, early stop at K = 1 and 2, done_in, per-edge weights, each with
    and without 3-bit messages, and (serial-C) both drivers, exactly equal
    to the plain version; every launch on a _cw entry point."""
    code = get_code(name)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    x = torch.randint(-3, 4, (96, code.n), generator=gen,
                      device=cuda).float()
    skip = torch.arange(96, device=cuda) % 3 == 0
    w = random_edge_weights(code, 4, seed=9)
    mq.reset_launch_counts()
    for qb in (None, 3):
        kw = dict(iterations=4, schedule=schedule, dtype=dtype, msg_qbits=qb,
                  msg_qclip=4.0, alpha=(1.0, 0.75, 0.5, 1.0),
                  beta=(0.0, 1.0, 2.5, 0.5), clamp=2.0)
        for extra in (dict(output="posterior"), dict(output="hard_unsat"),
                      dict(early_stop=True, es_check_every=1,
                           output="hard_iters"),
                      dict(early_stop=True, es_check_every=2,
                           output="hard_iters"),
                      dict(weights=w, output="posterior")):
            got = mq.bp_qc_cuda(x, code.qc, **kw, **extra)
            want = decode_roll(x, code.qc, **kw, **extra)
            for g, r in (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)]):
                assert torch.equal(g, r), (qb, extra.get("output"))
        got = mq.bp_qc_cuda(x, code.qc, output="posterior", done_in=skip,
                            **kw)
        want = decode_roll(x, code.qc, output="posterior", done_in=skip,
                           **kw)
        assert torch.equal(got[~skip], want[~skip])
    if schedule == "layered":
        st = dict(schedule="layered", dtype=dtype, msg_qclip=4.0)
        rb, ri = mq.bp_qc_requeue(x, code.qc, 6, probe_iters=2,
                                  es_check_every=1, output="hard_iters", **st)
        es = dict(st, early_stop=True, output="hard_iters")
        b1, i1 = decode_roll(x, code.qc, iterations=2, **es)
        b2, i2 = decode_roll(x, code.qc, iterations=6, **es)
        done = i1 < 2
        assert torch.equal(rb, torch.where(done[:, None], b1, b2))
        assert torch.equal(ri, torch.where(done, i1, 2 + i2))
        pb, _ = mq.bp_qc_probe_requeue(x, code.qc, 6, probe_iters=2,
                                       output="hard_iters", **st)
        b1, u1 = decode_roll(x, code.qc, iterations=2, output="hard_unsat",
                             **st)
        keep = (u1 == 0) & (96 - int((u1 == 0).sum())
                            <= mq.probe_capacity(96))
        assert torch.equal(pb, torch.where(keep[:, None], b1, decode_roll(
            x, code.qc, iterations=6, **st)))
    assert mq.ENTRY_LAUNCHES and all(
        e.split("_i8")[0].split("_bf16")[0].endswith("_cw")
        for e in mq.ENTRY_LAUNCHES), mq.ENTRY_LAUNCHES


def test_wide_state_kernels_have_no_stack_frame(cuda):
    """ptxas's report of the build: each of the 36 _cw kernels has a 0 B
    stack frame (every slot of a check unrolled to its degree)."""
    import re

    report = mq.build()[1]
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name is not None and "_cw" in name:
            found[name] = int(m.group(1))
    assert len(found) == 36 and not any(found.values()), found


def test_gather_backend_on_the_card(cuda):
    """The gather backend runs on a CUDA tensor and agrees with its run on
    the CPU: bits equal wherever |posterior| > 1e-4."""
    code = get_code("ref6432")
    x, _ = llrs(code, 512, "cpu", mu=1.5, seed=4)
    kw = dict(iterations=3, method="sum-product-ref", clamp=20.0,
              output="posterior")
    mq.reset_launch_counts()
    card = bp_decode(x.to(cuda), code, **kw).cpu()
    host = bp_decode(x, code, **kw)
    assert sum(mq.LAUNCHES.values()) == 0
    torch.testing.assert_close(card, host, rtol=1e-3, atol=1e-5)
    sure = host.abs() > 1e-4
    assert torch.equal((card > 0)[sure], (host > 0)[sure])


@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
def test_auto_with_gradient_decodes_on_the_plain_version(cuda, method):
    """LLRs that need a gradient: ``auto`` decodes on the roll backend and
    keeps the graph (no kernel launched), ``backend='cuda'`` raises, and
    under ``torch.no_grad()`` ``auto`` launches the kernel again."""
    code = get_code("wifi648")
    x = mixed_llrs(code, 37, cuda, seed=21).requires_grad_()
    kw = dict(iterations=4, schedule="layered", method=method)
    mq.reset_launch_counts()
    p1 = bp_decode(x, code, output="soft", **kw)
    (-torch.log(1.0 - p1 + 1e-7)).mean().backward()
    assert sum(mq.LAUNCHES.values()) == 0
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="carry no gradient"):
        bp_decode(x, code, backend="cuda", **kw)
    with torch.no_grad():
        got = bp_decode(x, code, output="posterior", **kw)
    assert mq.LAUNCHES[mq.KERNELS[method, "layered", False, False]] == 1
    torch.testing.assert_close(got, decode_roll(
        x.detach(), code.qc, output="posterior", **kw), rtol=1e-4, atol=1e-4)
