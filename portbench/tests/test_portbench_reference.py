"""The plain reference against brute force on a tiny QC code, and against
the program on the CPU."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference.code import Code
from portbench.reference.decode import Decoder

HERE = Path(__file__).resolve().parents[1]
# a 2 x 4 base of 3 x 3 circulants, its parity part block-triangular
TINY = [[1, 0, 0, -1], [2, 1, 0, 0]]


def tiny():
    return Code(TINY, 3, 6)


def test_expansion_is_the_shifted_identity():
    H = tiny().H()
    # block (1, 0) has shift 2: check 3 + r meets variable (r + 2) mod 3
    for r in range(3):
        assert H[3 + r, (r + 2) % 3] == 1
        assert H[3 + r].sum() == 4
    assert H[:3, 9:].sum() == 0


def test_encoder_gives_every_codeword():
    code = tiny()
    H = code.H().astype(np.int64)
    brute = {c for c in itertools.product((0, 1), repeat=code.n)
             if not (H @ np.asarray(c) % 2).any()}
    u = torch.tensor(list(itertools.product((0, 1), repeat=code.k)),
                     dtype=torch.int8)
    enc = {tuple(r) for r in code.encode(u).tolist()}
    assert len(brute) == 2 ** code.k and enc == brute


@pytest.mark.parametrize("name", ["wifi1944-qpsk-ofdm32"])
def test_encoder_matches_the_program(name):
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops.encode import encode

    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c = cfg["code"]
    code = Code(c["base"], c["z"], c["k"])
    prog = get_code(cfg["program_code"])
    assert (code.H() == prog.H).all()
    g = torch.Generator().manual_seed(5)
    u = torch.randint(0, 2, (8, code.k), generator=g, dtype=torch.int8)
    assert torch.equal(code.encode(u), encode(u, prog))


def _naive(code, llr, method, schedule, iterations, alpha, beta, clamp,
           early_stop):
    """One codeword at a time, one edge at a time, float32."""
    f = np.float32
    H = code.H()
    checks = [list(np.nonzero(H[c])[0]) for c in range(code.m)]
    var_checks = [list(np.nonzero(H[:, v])[0]) for v in range(code.n)]
    out_bits, out_iters = [], []
    for row in llr:
        L = (-row).astype(f)
        c2v = {(c, v): f(0) for c in range(code.m) for v in checks[c]}

        def phi_of(a):
            return f(f(np.log1p(np.exp(-a))) - f(np.log(-np.expm1(-a))))

        def rule(vals, it):
            res = []
            for e in range(len(vals)):
                others = [vals[o] for o in range(len(vals)) if o != e]
                neg = sum(1 for x in others if x < 0)
                sign = f(-1) if neg % 2 else f(1)
                if method == "min-sum":
                    m = min(abs(x) for x in others)
                    mag = f(max(f(m - f(beta[it])), f(0)) * f(alpha[it]))
                else:
                    # the sum over every slot, less the edge's own term
                    phi = [phi_of(max(abs(x), f(1e-12))) for x in vals]
                    s = f(0)
                    for t in phi:
                        s = f(s + t)
                    mag = phi_of(max(f(s - phi[e]), f(1e-12)))
                y = f(sign * mag)
                if clamp is not None:
                    y = f(min(max(y, f(-clamp)), f(clamp)))
                res.append(y)
            return res

        def posterior():
            if schedule == "layered":
                return post.copy()
            p = L.copy()
            for v in range(code.n):
                for c in var_checks[v]:
                    p[v] = f(p[v] + c2v[c, v])
            return p

        def ok(p):
            b = (p < 0).astype(int)
            return not (H.astype(int) @ b % 2).any()

        post = L.copy()
        done, ran = None, iterations
        if early_stop and ok(posterior()):
            done, ran = posterior(), 0
        for it in range(iterations):
            if done is not None:
                break
            if schedule == "flooding":
                p = posterior()
                new = {}
                for c in range(code.m):
                    vals = [f(p[v] - c2v[c, v]) for v in checks[c]]
                    for v, y in zip(checks[c], rule(vals, it)):
                        new[c, v] = y
                c2v = new
            else:
                for c in range(code.m):  # checks of a block row in turn
                    vals = [f(post[v] - c2v[c, v]) for v in checks[c]]
                    for v, y in zip(checks[c], rule(vals, it)):
                        post[v] = f(post[v] + f(y - c2v[c, v]))
                        c2v[c, v] = y
            if early_stop and ok(posterior()):
                done, ran = posterior(), it + 1
        final = posterior() if done is None else done
        out_bits.append((final < 0).astype(np.int8))
        out_iters.append(ran)
    return np.stack(out_bits), np.asarray(out_iters)


@pytest.mark.parametrize("method, schedule, clamp, early_stop, table", [
    ("min-sum", "flooding", None, False, False),
    ("min-sum", "layered", 20.0, True, False),
    ("min-sum", "layered", None, False, True),
    ("min-sum", "flooding", 2.5, True, True),
    ("sum-product", "flooding", None, False, False),
    ("sum-product", "layered", None, True, False),
])
def test_decoder_matches_naive(method, schedule, clamp, early_stop, table):
    code = tiny()
    T = 5
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.integers(0, 2, (24, code.k)).astype(np.int8))
    c = code.encode(u).numpy().astype(np.float32)
    # log(Pr1/Pr0) of BPSK in noise: positive leans to 1
    llr = ((2 * c - 1) * 2.0 + rng.normal(0, 2.2, c.shape)).astype(
        np.float32)
    alpha = [0.9, 0.8, 1.0, 0.7, 1.1] if table else 1.0
    beta = [0.1, 0.0, 0.2, 0.15, 0.05] if table else 0.0
    a_t = alpha if table else [1.0] * T
    b_t = beta if table else [0.0] * T
    dec = Decoder(code, "cpu", method, schedule, T, alpha=alpha, beta=beta,
                  clamp=clamp, early_stop=early_stop)
    bits, iters = dec.decode(torch.from_numpy(llr))
    nb, ni = _naive(code, llr, method, schedule, T, a_t, b_t, clamp,
                    early_stop)
    assert (bits.numpy() == nb).all()
    assert (iters.numpy() == ni).all()
    assert 0 < (nb != c).sum()  # the noise leaves errors to correct


def test_sum_product_rule_is_the_tanh_rule():
    code = tiny()
    dec = Decoder(code, "cpu", "sum-product", "flooding", 1)
    x = torch.tensor([[0.3, -1.7, 2.2, -0.05, 4.0]], dtype=torch.float32)
    y = dec.check_rule(x, 0, None).double()
    xd = x.double()
    for e in range(5):
        others = torch.cat([xd[0, :e], xd[0, e + 1:]])
        want = 2 * torch.atanh(torch.prod(torch.tanh(others / 2)))
        assert y[0, e].item() == pytest.approx(want.item(), rel=1e-5)


def test_bf16_storage_rounds():
    code = tiny()
    dec = Decoder(code, "cpu", "min-sum", "flooding", 1, storage="bfloat16")
    v = torch.tensor([1.0 + 2 ** -9])
    assert dec.store(v).item() == 1.0
