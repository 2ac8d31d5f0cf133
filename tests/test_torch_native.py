"""The port's native PEG builder against the JAX package's.

``make_regular_ldpc(..., backend='native')`` builds the port's own copy of
``peg.cc`` into ``build/native/``; its H must equal JAX's native H for the
same seed and hold the invariants of tests/test_kernels.py:196-211. JAX's
loader is pointed at a temporary directory here: left alone, it rebuilds
the tracked ``ldpc_sims_tpu/native/libpeg.so`` when that file is older
than its source.
"""

import hashlib

import numpy as np
import pytest

import ldpc_sims_tpu.native as jax_native
from ldpc_sims_tpu.codes import gf2 as jax_gf2
from ldpc_sims_tpu.codes.library import make_regular_ldpc as jax_make
from ldpc_sims_tpu_torch import native
from ldpc_sims_tpu_torch.codes import gf2, make_regular_ldpc


@pytest.fixture
def jax_native_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "_SO", str(tmp_path / "libpeg.so"))
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    if not jax_native.native_available():
        pytest.skip("no g++ toolchain")


@pytest.mark.parametrize("seed", [7, 8])
def test_native_peg_matches_jax(seed, jax_native_in_tmp):
    code = make_regular_ldpc(128, 64, 3, seed=seed, backend="native")
    ref = jax_make(128, 64, 3, seed=seed, backend="native")
    np.testing.assert_array_equal(code.H, ref.H)
    assert code.name == ref.name == "peg128_64"
    H = code.H.astype(np.int64)
    assert (H.sum(axis=0) == 3).all()
    ov = H.T @ H
    np.fill_diagonal(ov, 0)
    assert ov.max() <= 1  # girth > 4
    assert gf2.rank(code.H) == jax_gf2.rank(ref.H) == 64
    np.testing.assert_array_equal(
        code.H, make_regular_ldpc(128, 64, 3, seed=seed,
                                  backend="native").H)
    other = make_regular_ldpc(128, 64, 3, seed=15 - seed, backend="native")
    assert not np.array_equal(code.H, other.H)


def test_native_builds_its_own_source():
    """The library is built from the port's peg.cc into build/native/,
    named by the source's content; the source is the JAX package's
    algorithm, not its file."""
    lib = native.build()
    tag = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:12]
    assert lib == native.BUILD_DIR / f"libpeg_{tag}.so" and lib.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert "ldpc_sims_tpu_torch" in native.SOURCE.parts
    with pytest.raises(RuntimeError, match="peg_construct failed"):
        native.peg_construct_native(16, 4, 5)  # col_deg > m
