"""Checkpoints in the JAX package's format, read and written by the port's
own msgpack codec (CPU; flax and optax on the JAX side only).

* A checkpoint from the JAX package's ``save_checkpoint`` of an LLR
  estimator with an adam or sgd ``opt_state`` reads in the port as nested
  dicts of NumPy arrays, and its params run in the port's estimator as
  they run in flax.
* The port's checkpoint reads in the JAX package's ``load_checkpoint(path,
  template)`` with every array equal, a bfloat16 leaf and a NumPy scalar
  included, and its bytes are the JAX package's for the same tree.
* The codec on its own against flax's ``msgpack_serialize``/``restore``:
  every type flax writes, each length class of str, bin, array, map and
  ext, every integer width; a chunked array and an over-long one raise.
* ``load_decoder_weights`` on a ``{"params": {"ms_alpha", "ms_beta"}}``
  directory equals the JAX package's; ``latest_checkpoint`` follows it.
"""

import os
import time

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldpc_sims_tpu.models import LLRestimator as FlaxLLRestimator
from ldpc_sims_tpu.utils import checkpoint as jax_ckpt
from ldpc_sims_tpu_torch.convert import (
    llr_params_to_flax,
    llr_state_dict_from_flax,
)
from ldpc_sims_tpu_torch.models import LLRestimator
from ldpc_sims_tpu_torch.utils import (
    latest_checkpoint,
    load_checkpoint,
    load_decoder_weights,
    save_checkpoint,
)
from ldpc_sims_tpu_torch.utils.msgpack_codec import restore, serialize


def _flax_llr(ofdm=8):
    model = FlaxLLRestimator(ofdm)
    params = model.init(jax.random.key(0), jnp.zeros((2, 2 * ofdm)))
    return model, params


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_port_reads_jax_checkpoint(tmp_path, opt):
    model, params = _flax_llr()
    tx = optax.adam(1e-3) if opt == "adam" else optax.sgd(0.01, 0.9)
    opt_state = tx.init(params)
    path = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(path, {"params": params,
                                    "opt_state": opt_state},
                             {"model": "LLRestimator", "epochs": 3,
                              "train_loss": np.float32([1.5, 0.5])})
    tree, manifest = load_checkpoint(path)
    assert manifest == {"model": "LLRestimator", "epochs": 3,
                        "train_loss": [1.5, 0.5]}
    assert set(tree) == {"params", "opt_state"}
    want = jax.tree.map(np.asarray, fs.to_state_dict(
        {"params": params, "opt_state": opt_state}))
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if opt == "adam":
        assert set(tree["opt_state"]["0"]) == {"count", "mu", "nu"}
    # the params run in the port as in flax
    port = LLRestimator(8)
    port.load_state_dict(llr_state_dict_from_flax(tree["params"]))
    x = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(model.apply(params, x)),
                               rtol=0, atol=1e-5)


def test_jax_reads_port_checkpoint(tmp_path):
    model, params = _flax_llr()
    port = LLRestimator(8, generator=torch.Generator().manual_seed(4))
    tree = {
        "params": llr_params_to_flax(port),
        "opt_state": None,
        "extra": {"bf16": torch.arange(6, dtype=torch.bfloat16) / 3,
                  "scalar": np.float32(2.5), "step": np.int64(-7),
                  "count": torch.tensor(12, dtype=torch.int32)},
    }
    path = save_checkpoint(str(tmp_path / "port"), tree,
                           {"model": "LLRestimator", "lr": np.float32(0.5)})
    template = {"params": params, "opt_state": None,
                "extra": {"bf16": None, "scalar": None, "step": None,
                          "count": None}}
    got, manifest = jax_ckpt.load_checkpoint(path, template)
    assert manifest == {"model": "LLRestimator", "lr": 0.5}
    for layer, leaves in tree["params"]["params"].items():
        for kind, a in leaves.items():
            np.testing.assert_array_equal(
                np.asarray(got["params"]["params"][layer][kind]), a)
    bf = got["extra"]["bf16"]
    assert bf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(bf, np.float32),
        tree["extra"]["bf16"].to(torch.float32).numpy())
    assert got["extra"]["scalar"] == np.float32(2.5)
    assert got["extra"]["step"] == -7 and got["extra"]["count"] == 12
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        np.asarray(model.apply(got["params"], x)), want, rtol=0, atol=1e-5)
    # byte for byte the JAX package's checkpoint of the same tree
    jax_tree = dict(tree, extra=dict(
        tree["extra"], bf16=jnp.arange(6, dtype=jnp.bfloat16) / 3,
        count=np.int32(12)))
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jax_tree)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        ours = f.read()
    with open(os.path.join(jpath, "params.msgpack"), "rb") as f:
        assert f.read() == ours
    # and the port reads its own checkpoint back
    back, _ = load_checkpoint(path)
    assert back["extra"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["extra"]["bf16"], tree["extra"]["bf16"])
    assert back["opt_state"] is None and back["extra"]["step"] == -7


def test_codec_matches_flax_msgpack():
    rng = np.random.default_rng(2)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**63, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "é" * 40000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "flags": [True, False, None],
        "long": list(range(16)) + [list(range(70000))],
        "map16": {str(i): i for i in range(16)},
        "arrays": {n: rng.normal(size=s).astype(d) for n, s, d in (
            ("f32", (3, 4), np.float32), ("f64", (2,), np.float64),
            ("i8", (5,), np.int8), ("u16", (2, 2), np.uint16),
            ("b", (3,), np.bool_), ("e", (0, 3), np.float32),
            ("s", (), np.float32))},
        "ext_sizes": {str(i): np.zeros(i, np.uint8) for i in range(0, 40)},
        "npscalars": [np.float32(1.25), np.int64(-3), np.bool_(True)],
        "c": complex(1.5, -2.0),
        "tup": (1, (2, 3)),
    }
    tree["arrays"]["b"] = tree["arrays"]["b"] > 0
    # to_bytes maps tuples and lists to dicts keyed '0', '1', ...
    assert serialize(tree) == fs.to_bytes(tree)
    # raw msgpack arrays (lists) to read back
    want = fs.msgpack_serialize({k: v for k, v in tree.items()
                                 if k != "tup"})
    got = restore(want)
    ref = fs.msgpack_restore(want)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
    bf = fs.msgpack_serialize({"w": jnp.ones((2, 3), jnp.bfloat16) * 1.5})
    t = restore(bf)["w"]
    assert t.dtype == torch.bfloat16 and t.shape == (2, 3)
    assert serialize({"w": t}) == bf


def test_codec_refuses_chunks_and_big_arrays(monkeypatch):
    from flax import serialization as fser

    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    chunked = fser.msgpack_serialize({"w": np.zeros(100, np.float32)})
    with pytest.raises(ValueError, match="chunked array"):
        restore(chunked)
    from ldpc_sims_tpu_torch.utils import msgpack_codec

    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="exceeds"):
        serialize({"w": np.zeros(100, np.float32)})
    with pytest.raises(TypeError, match="cannot serialize"):
        serialize({"w": object()})
    with pytest.raises(ValueError, match="truncated"):
        restore(fs.msgpack_serialize({"w": np.zeros(3)})[:-1])


def test_load_decoder_weights_directory_matches_jax(tmp_path):
    ms = {"ms_alpha": np.float32([0.8, 0.85, 0.9]),
          "ms_beta": np.float32([0.1, 0.05, 0.0])}
    path = str(tmp_path / "ms")
    jax_ckpt.save_checkpoint(path, {"params": ms,
                                    "opt_state": optax.adam(0.1).init(ms)})
    want = jax_ckpt.load_decoder_weights(path)
    got = load_decoder_weights(path)
    assert set(got) == set(want) == set(ms)
    for k in ms:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    # at the top of the tree, as train_neural_bp writes them
    top = jax_ckpt.save_checkpoint(str(tmp_path / "top"), ms)
    for k, v in load_decoder_weights(top).items():
        np.testing.assert_array_equal(v, ms[k])


def test_latest_checkpoint(tmp_path):
    root = str(tmp_path)
    assert latest_checkpoint(root) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    a = save_checkpoint(os.path.join(root, "llr_a"), {"w": np.zeros(2)})
    b = jax_ckpt.save_checkpoint(os.path.join(root, "llr_b"),
                                 {"w": np.zeros(2)})
    os.makedirs(os.path.join(root, "llr_c"))  # no params.msgpack
    now = time.time()
    os.utime(a, (now, now))
    os.utime(b, (now - 10, now - 10))
    for prefix in ("", "llr_", "llr_b"):
        assert (latest_checkpoint(root, prefix)
                == jax_ckpt.latest_checkpoint(root, prefix))
    assert latest_checkpoint(root) == a
    assert latest_checkpoint(root, "llr_b") == b
    assert latest_checkpoint(root, "other") is None
