"""bf16 and int8 message storage in the port (plain version, CPU) against
the JAX package's Pallas kernel.

JAX has the storage types in its Pallas kernel only, so the port's plain
version is held to ``bp_qc_pallas(..., interpret=True, dtype=...)`` on the
same numpy LLRs (wifi648, batch 128, 2 iterations): int8 posteriors within
rtol = atol = 1e-4 and hard bits equal (XLA fuses the lift f32(q)·qstep
into the posterior sums with a multiply-add, the port does not); bf16
posteriors within two bf16 ulps (rtol 2⁻⁷: a last-bit f32 difference can
flip one rounding) and hard bits equal wherever |JAX posterior| > 0.1;
bf16 early-stop iteration counts equal. Each interpret-mode call costs
about 8 s: five in this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.kernels import bp_qc_pallas
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops import bp_decode
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, message_storage
from test_torch_group_serial import degree10_qc

NAME = "wifi648"
JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def channel_llrs(batch, mu=2.0, seed=0):
    """Consistent-Gaussian LLRs (mean ±mu, variance 2mu), log(Pr1/Pr0),
    of random codewords."""
    code = get_code(NAME)
    rng = np.random.default_rng(seed)
    cw = code.encode_np(rng.integers(0, 2, (batch, code.k)))
    llr = (2.0 * cw - 1.0) * mu + rng.normal(0, np.sqrt(2 * mu), cw.shape)
    return np.ascontiguousarray(llr, np.float32)


def bf16_representable(x: torch.Tensor) -> bool:
    return torch.equal(x.to(torch.bfloat16).to(torch.float32), x)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_storage_matches_pallas_interpret(dtype, schedule):
    llr = channel_llrs(128)
    kw = dict(iterations=2, schedule=schedule)
    if dtype == torch.int8:
        kw["msg_qclip"] = 24.0
    ref = np.array(bp_qc_pallas(
        jnp.asarray(llr), jax_get_code(NAME).qc, method="min-sum",
        dtype=JAX_DTYPES[dtype], interpret=True, output="posterior", **kw))
    # the kernels' storage (their plain version on a CPU tensor)
    ours = bp_decode(torch.from_numpy(llr), get_code(NAME), dtype=dtype,
                     output="posterior", backend="cuda", **kw)
    if dtype == torch.int8:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ours.numpy() > 0, ref > 0)
    else:
        assert bf16_representable(ours)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2.0**-7, atol=0)
        sure = np.abs(ref) > 0.1
        np.testing.assert_array_equal((ours.numpy() > 0)[sure],
                                      (ref > 0)[sure])
    # the storage changes the decode: it is not the f32 one
    f32 = bp_decode(torch.from_numpy(llr), get_code(NAME), output="posterior",
                    **kw)
    assert not torch.equal(ours, f32)


def test_bf16_early_stop_matches_pallas_interpret():
    """Early-stop freeze under bf16 layered: the iteration counts equal,
    the bits equal where JAX's count is below the budget (converged)."""
    llr = channel_llrs(128, mu=4.0, seed=1)
    kw = dict(iterations=4, schedule="layered", early_stop=True,
              output="hard_iters")
    jbits, jiters = bp_qc_pallas(
        jnp.asarray(llr), jax_get_code(NAME).qc, method="min-sum",
        dtype=jnp.bfloat16, interpret=True, **kw)
    bits, iters = bp_decode(torch.from_numpy(llr), get_code(NAME),
                            dtype=torch.bfloat16, backend="cuda", **kw)
    np.testing.assert_array_equal(iters.numpy(), np.array(jiters))
    assert 0 < int((iters < 4).sum()) < 128
    done = np.array(jiters) < 4
    np.testing.assert_array_equal(bits.numpy()[done], np.array(jbits)[done])


def test_int8_messages_lie_on_the_grid():
    """The storage function the decode uses: clip(round(v·(1/qstep)),
    −127, 127)·qstep with the f32 reciprocal, half to even; the posterior
    stays f32."""
    clip = 24.0
    step = np.float32(2.0 * clip / 255.0)
    inv = np.float32(1.0 / (2.0 * clip / 255.0))
    st_msg, st_post = message_storage(torch.int8, clip)
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.normal(0, 10, 1000), [0.0, 1e3, -1e3],
                        (np.arange(-5, 6) + 0.5) * step]).astype(np.float32)
    got = st_msg(torch.from_numpy(v)).numpy()
    q = np.clip(np.rint(v * inv), -127, 127)
    np.testing.assert_array_equal(got, (q * step).astype(np.float32))
    np.testing.assert_array_equal(np.rint(got / step), q)
    assert np.abs(q).max() == 127
    assert torch.equal(st_post(torch.from_numpy(v)), torch.from_numpy(v))
    # the messages of an int8 decode are on that grid: a flooding
    # posterior is the LLR less a sum of stored messages, so LLR − post is
    # a whole number of steps (up to the f32 rounding of the sum); f32
    # messages are not
    code = get_code(NAME)
    llr = torch.from_numpy(channel_llrs(4))
    for dt, on_grid in ((torch.int8, True), (torch.float32, False)):
        post = decode_roll(llr, code.qc, iterations=2, dtype=dt,
                           msg_qclip=clip, output="posterior")
        k = (llr - post).numpy() / step
        off = np.abs(k - np.rint(k)).max()
        assert (off < 1e-3) == on_grid, (dt, off)
        assert np.abs(np.rint(k)).max() > 0


def test_bf16_posteriors_are_representable():
    code = get_code(NAME)
    llr = torch.from_numpy(channel_llrs(8, seed=4))
    for kw in (dict(schedule="flooding"), dict(schedule="layered"),
               dict(schedule="layered", layered_group=3),
               dict(schedule="flooding", method="sum-product", msg_qbits=4)):
        post = bp_decode(llr, code, iterations=3, dtype=torch.bfloat16,
                         output="posterior", **kw)
        assert bf16_representable(post), kw


@pytest.mark.parametrize("kw", [
    dict(schedule="flooding"),
    dict(schedule="layered", alpha=0.8, beta=0.1, clamp=6.0),
    dict(schedule="flooding", method="sum-product", msg_qbits=4),
    dict(schedule="layered", layered_group=3),
    dict(schedule="layered", early_stop=True, output="hard_iters"),
], ids=["flooding", "layered-a-b-clamp", "sp-msgq4", "group3", "es"])
def test_float32_unchanged(kw):
    """dtype=float32 (or its name) is the decode as it was: bit for bit."""
    code = get_code(NAME)
    llr = torch.from_numpy(channel_llrs(8, seed=5))
    kw = {"output": "posterior", **kw}
    base = decode_roll(llr, code.qc, iterations=3, **kw)
    for dt in (torch.float32, "float32"):
        out = decode_roll(llr, code.qc, iterations=3, dtype=dt, **kw)
        pairs = zip(out, base) if isinstance(out, tuple) else [(out, base)]
        assert all(torch.equal(a, b) for a, b in pairs)
    out = bp_decode(llr, code, iterations=3, backend="cuda",
                    dtype=torch.float32, **kw)
    pairs = zip(out, base) if isinstance(out, tuple) else [(out, base)]
    assert all(torch.equal(a, b) for a, b in pairs)


def test_dispatch_rules():
    """bf16 and int8 take the kernels' module on a CUDA tensor and with
    ``backend='cuda'`` (the plain version on a CPU tensor); on a CPU tensor
    ``auto`` sends bf16 to the roll backend, which computes in bf16 as
    JAX's does, and raises for int8 with JAX's ValueError; other types
    raise."""
    code = get_code(NAME)
    llr = torch.from_numpy(channel_llrs(4, seed=6))
    for dt in (torch.bfloat16, torch.int8):
        cuda = bp_decode(llr, code, iterations=2, dtype=dt,
                         output="posterior", backend="cuda")
        assert torch.equal(cuda, decode_roll(llr, code.qc, iterations=2,
                                             dtype=dt, output="posterior"))
    auto = bp_decode(llr, code, iterations=2, dtype=torch.bfloat16,
                     output="posterior")
    roll = bp_decode(llr, code, iterations=2, dtype=torch.bfloat16,
                     output="posterior", backend="roll")
    assert torch.equal(auto, roll)
    assert torch.equal(auto, decode_roll(llr, code.qc, iterations=2,
                                         arith=torch.bfloat16,
                                         output="posterior"))
    with pytest.raises(ValueError, match="int8 message storage"):
        bp_decode(llr, code, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 message storage"):
        bp_decode(llr, code, dtype=torch.int8, backend="roll")
    with pytest.raises(ValueError, match="storage dtype"):
        bp_decode(llr, code, dtype=torch.float16)
    with pytest.raises(ValueError, match="msg_qclip"):
        bp_decode(llr, code, dtype=torch.int8, msg_qclip=0.0)
    # the drivers pass the storage to both passes
    mq.reset_launch_counts()
    for mode in ("requeue", "probe"):
        bits, iters = bp_decode(llr, code, iterations=4, schedule="layered",
                                early_stop=True, es_mode=mode,
                                es_probe_iters=2, dtype=torch.int8,
                                msg_qclip=24.0, output="hard_iters")
        assert bits.shape == llr.shape and iters.shape == (4,)
    assert sum(mq.LAUNCHES.values()) == 0  # no kernel on the CPU


@pytest.mark.parametrize("threads, match", [
    (48, "multiple of 32"), (0, "multiple of 32"), (2048, "multiple of 32"),
])
def test_threads_validation(threads, match):
    qc = get_code(NAME).qc
    with pytest.raises(ValueError, match=match):
        mq.bp_qc_cuda(torch.zeros((2, 648)), qc, iterations=2,
                      threads=threads)
    with pytest.raises(ValueError, match="layered CTA"):
        mq.bp_qc_cuda(torch.zeros((2, 648)), qc, iterations=2,
                      schedule="layered", threads=256)
    assert mq.default_threads(qc, torch.bfloat16) == 256
    # the H100 sweep's entries: the 5G-class codes flood with 1024
    assert mq.default_threads(get_code("qc12288_r12").qc) == 1024


def test_auto_diverges_from_jax_cpu_auto():
    """JAX's CPU ``auto`` and the port's agree (ROADMAP §C, settled): bf16
    goes to the roll backend in bf16 arithmetic on both, posteriors within
    one bf16 ulp (equal on this input), and int8 raises ValueError on
    both."""
    llr = channel_llrs(8, seed=7)
    jcode = jax_get_code(NAME)
    with pytest.raises(ValueError, match="int8"):
        jax_bp_decode(jnp.asarray(llr), jcode, iterations=2,
                      method="min-sum", dtype=jnp.int8)
    with pytest.raises(ValueError, match="int8"):
        bp_decode(torch.from_numpy(llr), get_code(NAME), iterations=2,
                  dtype=torch.int8)
    jref = np.array(jax_bp_decode(jnp.asarray(llr), jcode, iterations=2,
                                  method="min-sum", dtype=jnp.bfloat16,
                                  output="posterior"), np.float32)
    ours = bp_decode(torch.from_numpy(llr), get_code(NAME), iterations=2,
                     dtype=torch.bfloat16, output="posterior").numpy()
    np.testing.assert_allclose(ours, jref, rtol=2.0**-7, atol=0)


def test_smem_bytes_per_storage_type():
    """Each region sized by its type on a 16-byte boundary; the 5G-class
    codes' bf16 and int8 halve their f32 footprint or better. Sum-product
    keeps the full messages, serial-C, flooding and group-serial
    sum-product without the plan (their kernel parameter holds it),
    flooding with the LLRs beside the posterior, group-serial with the
    scratch of the largest group's shared planes; min-sum, serial-C and
    flooding, keeps the compressed check state: two stored magnitudes and
    a 2-byte word a check, flooding without the plan and with the LLRs
    beside the posterior, in its storage type. A code beyond the limits
    by its row degree alone (qc1944_r23) takes the same designs on the
    wide rows: min-sum's compressed state with a 4-byte word a check (the
    wide word), sum-product's messages without the plan, G > 1 with the
    scratch of the largest group's shared planes; a code with a row of a
    degree no wide body has keeps the full messages and the plan, with
    the scratch of a group's planes for G > 1."""
    sp = dict(method="sum-product", schedule="layered")
    ms = dict(method="min-sum", schedule="layered")
    fl = dict(method="min-sum", schedule="flooding")
    qc = get_code("wifi1944").qc  # plan 296 ints, P·z = 6966, n = 1944
    assert mq.smem_bytes(qc, 1, torch.bfloat16, **sp) == 13936 + 3888
    assert mq.smem_bytes(qc, 1, torch.int8, **sp) == 6976 + 7776
    # 972 checks: magnitudes 8, 4 or 2 B, words 1944 B (1952 aligned)
    assert mq.smem_bytes(qc, 1, **ms) == 1184 + 7776 + 1952 + 7776
    assert mq.smem_bytes(qc, 1, torch.bfloat16, **ms) == (1184 + 3888
                                                          + 1952 + 3888)
    assert mq.smem_bytes(qc, 1, torch.int8, **ms) == (1184 + 1952 + 1952
                                                      + 7776)
    big = get_code("qc12288_r12").qc
    # the full messages with their 896 B plan less the plan: serial-C
    # sum-product, and group-serial at G = 2 with the scratch of the
    # largest group's 8 shared planes
    assert mq.smem_bytes(big, 2, **sp) == 174_976 - 896 + 4 * 8 * 512
    assert mq.smem_bytes(big, **sp) == 174_976 - 896
    # beyond the limits by the row degree alone (qc1944_r23: 65 planes,
    # rows of degree 8-9) G = 2 takes the _gw kernels: the messages and
    # the scratch of its largest group's 12 shared planes, no plan; with a
    # row of degree 10 (qc1944_r34's base with one circulant dropped: 66
    # planes, rows of degree 10-12) G = 2 keeps the full messages with
    # the plan (230 ints, 928 B) and the scratch of min(P, 2·12) planes
    r23 = get_code("qc1944_r23").qc
    assert mq.smem_bytes(r23, 2, **sp) == 21_072 + 7776 + 4 * 12 * 81
    assert mq.smem_bytes(r23, 2, torch.bfloat16, **sp) == (
        10_544 + 3888 + 4 * 12 * 81)
    d10 = degree10_qc()
    assert mq.smem_bytes(d10, 2, **sp) == 928 + 21_392 + 7776 + 4 * 24 * 81
    assert mq.smem_bytes(d10, 2, torch.bfloat16, **sp) == (
        928 + 10_704 + 3888 + 4 * 24 * 81)
    assert mq.smem_bytes(big, 1, torch.bfloat16, **sp) == 87_936 - 896
    assert mq.smem_bytes(big, 1, torch.int8, **sp) == 81_280 - 896
    # two f32 CTAs an SM (115,712 B each with the 1 KB a CTA reserves)
    assert mq.smem_bytes(big, **ms) == 111_488
    assert mq.smem_bytes(big, 1, torch.bfloat16, **ms) == 62_336
    assert mq.smem_bytes(big, 1, torch.int8, **ms) == 74_624
    # qc8448: three f32 CTAs an SM (76,800 B each)
    q8448 = get_code("qc8448_r12").qc
    assert mq.smem_bytes(q8448, **ms) == 75_968
    # flooding: the serial-C bytes less the plan (1,184 B at wifi1944)
    # and with the LLRs (4 B a variable, bf16 2); sum-product flooding as
    # its serial-C with the LLRs
    for dt, llr in ((torch.float32, 7776), (torch.bfloat16, 3888),
                    (torch.int8, 7776)):
        assert mq.smem_bytes(qc, 1, dt, **fl) == mq.smem_bytes(
            qc, 1, dt, **ms) - 1184 + llr
        assert mq.smem_bytes(qc, 1, dt, method="sum-product") == \
            mq.smem_bytes(qc, 1, dt, **sp) + llr
    # one f32 or int8 CTA an SM at qc12288, two at bf16
    assert mq.smem_bytes(big, **fl) == 159_744
    assert mq.smem_bytes(big, 1, torch.bfloat16, **fl) == 86_016
    assert mq.smem_bytes(big, 1, torch.int8, **fl) == 122_880
    assert mq.smem_bytes(q8448, **fl) == 108_544
    # one f32 sum-product flooding CTA an SM at qc12288
    assert mq.smem_bytes(big, method="sum-product") == 174_080 + 49_152
    # G = mb (all 61 planes shared) does not fit at f32 but does at bf16
    # (the group-serial scratch holds the largest group's shared planes
    # only, so G = 5 fits at f32 too)
    assert mq.smem_bytes(big, 12, **ms) > mq._SMEM_LIMIT
    assert mq.smem_bytes(big, 12, torch.bfloat16, **ms) <= mq._SMEM_LIMIT
    assert mq.smem_bytes(big, 5, **ms) <= mq._SMEM_LIMIT
    # the compressed state's limits: rows of degree 8 take its 2-byte word,
    # 9 its 4-byte wide word (qc1944_r23: 648 checks, 2,592 B of words;
    # serial-C with the plan's 928 B, flooding with the LLRs instead)
    r23 = get_code("qc1944_r23").qc
    for kw in (ms, fl):
        assert mq.compressed_state(get_code("wifi648").qc, **kw)
        assert mq.compressed_state(r23, **kw)
        assert mq.design(r23, **kw) == "compressed-wide"
        assert not mq.compressed_state(d10, **kw)
    assert mq.compressed_state(r23, layered_group=2, **ms)
    assert mq.design(r23, layered_group=2, **ms) == "group-wide"
    assert mq.smem_bytes(r23, 2, **ms) == (648 * 8 + 648 * 4 + 7776
                                           + 4 * 12 * 81)
    assert mq.smem_bytes(d10, 2, **ms) == mq.smem_bytes(d10, 2, **sp)
    assert mq.smem_bytes(r23, **ms) == 928 + 648 * 8 + 648 * 4 + 7776
    assert mq.smem_bytes(r23, **fl) == 648 * 8 + 648 * 4 + 2 * 7776
    assert not mq.compressed_state(qc, "sum-product", "flooding")
    assert mq.sumproduct_registers(r23, "sum-product", "layered")
    assert not mq.sumproduct_registers(r23, "sum-product", "flooding")
    assert not mq.sumproduct_registers(d10, "sum-product", "layered")


def test_bigcode_and_tuner_need_a_card(monkeypatch, capsys):
    """The scale run and the tuner time the card: without one both exit
    non-zero with a message and print no result."""
    from ldpc_sims_tpu_torch.examples import bigcode
    from ldpc_sims_tpu_torch.kernels import tune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bigcode.main() == 1 and tune.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and out.err.count("no CUDA device") == 2
    with pytest.raises(RuntimeError, match="CUDA card"):
        bigcode.run(["qc8448_r12"], 8, 1, (2.0,))
