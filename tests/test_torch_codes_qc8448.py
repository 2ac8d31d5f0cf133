"""The port's qc8448_r12 against the JAX package's (its own file: building it in
both packages takes ~20 s)."""

from test_torch_codes import assert_same_code


def test_qc8448_identical_to_jax():
    assert_same_code("qc8448_r12")
