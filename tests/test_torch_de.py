"""Protograph density evolution against the JAX package (CPU).

* On the (3,6)-regular protograph ``BASE36`` with ``tests/test_de.py``'s
  settings (80 iterations, 4096 samples), both packages converge at 2.0
  dB (error < 1e-3) and stay stuck at 0.3 dB (error > 5e-2), for
  sum-product and min-sum. Their random streams differ, so the numbers
  are not tied bit for bit, only the brackets.
* The port's sum-product threshold of the (3,6) ensemble is within 0.15
  dB of the textbook 1.11 dB (σ* = 0.8797), at 150 iterations and 8192
  samples; min-sum sits 0.3-1.0 dB above it.
* An unknown method and a run that does not converge at ``snr_hi_db``
  raise ``ValueError``, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes.de import protograph_de_error as jax_de_error
from ldpc_sims_tpu_torch.codes.de import (
    _plan,
    de_threshold,
    protograph_de_error,
)

BASE36 = np.zeros((3, 6), np.int64)  # (3,6)-regular protograph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_de_brackets_match_jax(method):
    kw = dict(method=method, iterations=80, samples=1 << 12)
    for de, extra in ((jax_de_error, {}),
                      (protograph_de_error, {"device": "cpu"})):
        hi = de(BASE36, 2.0, **kw, **extra)
        lo = de(BASE36, 0.3, **kw, **extra)
        assert hi < 1e-3, (de.__module__, hi)
        assert lo > 5e-2, (de.__module__, lo)


def test_de_threshold_36_regular_anchor():
    th_sp = de_threshold(BASE36, method="sum-product", iterations=150,
                         samples=1 << 13, device="cpu")
    assert abs(th_sp - 1.11) < 0.15, th_sp
    # min-sum (α = 1, β = 0) loses 0.3-1.0 dB on the same ensemble
    ms = protograph_de_error(BASE36, th_sp + 0.25, method="min-sum",
                             iterations=150, samples=1 << 13, device="cpu")
    assert ms > 1e-4, ms


def test_de_is_seeded_and_clamps():
    kw = dict(method="min-sum", iterations=10, samples=1 << 10,
              device="cpu")
    a = protograph_de_error(BASE36, 1.5, seed=3, **kw)
    assert a == protograph_de_error(BASE36, 1.5, seed=3, **kw)
    assert a != protograph_de_error(BASE36, 1.5, seed=4, **kw)
    # a clamp well inside the messages' range slows convergence
    free = protograph_de_error(BASE36, 2.0, method="min-sum", iterations=30,
                               samples=1 << 12, device="cpu")
    tight = protograph_de_error(BASE36, 2.0, method="min-sum",
                                iterations=30, samples=1 << 12, clamp=0.5,
                                device="cpu")
    assert tight > free


def test_plan_groups_planes_like_jax():
    from ldpc_sims_tpu.codes.de import _plan as jax_plan

    base = np.array([[0, -1, 3, 1], [-1, 2, 0, -1], [4, 4, -1, 0]])
    assert _plan(base) == jax_plan(base)


def test_de_rejects_unknown_method_and_non_convergence():
    with pytest.raises(ValueError, match="method"):
        protograph_de_error(BASE36, 1.0, method="max-product", device="cpu")
    with pytest.raises(ValueError, match="does not converge"):
        de_threshold(BASE36, method="sum-product", snr_hi_db=0.0,
                     iterations=20, samples=1 << 10, device="cpu")
