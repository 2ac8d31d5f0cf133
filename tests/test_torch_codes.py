"""The port's code library against the JAX package's, name by name.

The two largest codes (qc8448_r12, qc12288_r12) take ~20 s each to build
in the two packages together, so each has a file of its own
(test_torch_codes_qc8448.py, test_torch_codes_qc12288.py).
"""

import json
import os

import numpy as np
import pytest

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.codes import list_codes as jax_list_codes
from ldpc_sims_tpu.ops.bp_roll import qc_plan as jax_qc_plan
from ldpc_sims_tpu_torch.codes import get_code, list_codes
from ldpc_sims_tpu_torch.codes import make_regular_ldpc
from ldpc_sims_tpu_torch.convert import (
    code_from_numpy,
    load_trained_schedule,
    minsum_schedule_from_numpy,
)
from ldpc_sims_tpu_torch.ops.bp_roll import qc_plan

LARGE = ("qc8448_r12", "qc12288_r12")
SCHEDULES = os.path.join(os.path.dirname(__file__), "..", "docs",
                         "artifacts", "minsum_trained_schedules.json")


def assert_same_code(name):
    """H, G, perm, qc.base and the QC decode plan are identical."""
    a, b = get_code(name), jax_get_code(name)
    assert a.name == b.name
    np.testing.assert_array_equal(a.H, b.H)
    np.testing.assert_array_equal(a.G, b.G)
    np.testing.assert_array_equal(a.perm, b.perm)
    assert a.n_edges == b.n_edges
    assert (a.qc is None) == (b.qc is None)
    if a.qc is not None:
        assert a.qc.z == b.qc.z and a.qc.base == b.qc.base
        assert qc_plan(a.qc) == jax_qc_plan(b.qc)


def test_registry_names_match():
    assert list_codes() == jax_list_codes()
    assert len(list_codes()) == 14


@pytest.mark.parametrize(
    "name", [n for n in jax_list_codes() if n not in LARGE]
)
def test_code_identical_to_jax(name):
    assert_same_code(name)


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "qc648_r34"])
def test_code_from_numpy_round_trip(name):
    ref = jax_get_code(name)
    code = code_from_numpy(name, ref.H, z=ref.qc.z,
                           base=np.asarray(ref.qc.base))
    assert code.qc == get_code(name).qc
    np.testing.assert_array_equal(code.G, ref.G)
    plain = code_from_numpy("ref", jax_get_code("ref6432").H)
    assert plain.qc is None and plain.k == 32
    with pytest.raises(ValueError, match="both z and base"):
        code_from_numpy(name, ref.H, z=ref.qc.z)


def test_trained_schedule_from_registry():
    with open(SCHEDULES) as f:
        entry = json.load(f)["wifi1944"]["layered"]["8"]
    a, b = load_trained_schedule(SCHEDULES, "wifi1944", 8)
    assert a == tuple(entry["alpha"]) and b == tuple(entry["beta"])
    assert len(a) == 8
    assert minsum_schedule_from_numpy(np.float32(a), np.float32(b)) == (
        tuple(float(np.float32(x)) for x in a),
        tuple(float(np.float32(x)) for x in b),
    )
    with pytest.raises(KeyError, match="layered-3"):
        load_trained_schedule(SCHEDULES, "wifi1944", 3)


def test_native_peg_backend_not_ported(tmp_path, monkeypatch):
    """The native PEG backend, which raised until it was ported: it builds
    (tests/test_torch_native.py holds it to JAX's); with no compiler it
    raises naming g++ and falls back to nothing."""
    from ldpc_sims_tpu_torch import native

    code = make_regular_ldpc(128, 64, 3, seed=1, backend="native")
    assert code.name == "peg128_64" and (code.H.sum(axis=0) == 3).all()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make_regular_ldpc(128, 64, 3, seed=1, backend="native")
    finally:
        native._library.cache_clear()
    assert not list(tmp_path.iterdir())
