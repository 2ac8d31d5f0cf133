"""The study and training examples end to end at their smallest sizes, and
the public names the port shares with the JAX package.

* Each of the seven examples' ``main()`` on the CPU (``*_DEVICE=cpu``,
  the sizes their variables allow, the sizes the JAX scripts hard-code
  cut through the module's constants): it writes only under its
  ``*_OUT`` (nothing in the working directory) with the JAX script's
  keys, and no file under ``docs/artifacts/`` changes, the committed
  registry included.
* ``train_edge_layered_1944``'s registry copy and npz feed the error-floor
  campaign through ``EF_REGISTRY``.
* ``tanh_family``: both arms' estimator-independent columns are equal.
* ``quantized_llr_study`` without matplotlib stops before drawing data.
* chip_smoke.py's emulation of the JAX Pallas kernel's sum-product
  arithmetic against that kernel in interpret mode on saturated LLRs.
* ``native.native_available`` (true here; false, without raising, when
  the compiler is missing), the ``kernels`` re-export of
  ``bp_qc_requeue``, and every public name of every JAX module present in
  the port's module of the same path, or in the rename/no-counterpart map
  that README's table gives.
"""

import functools
import importlib
import inspect
import json
import os
import pkgutil
import sys

import numpy as np
import pytest
import torch

import ldpc_sims_tpu
from ldpc_sims_tpu_torch import kernels, native
from ldpc_sims_tpu_torch.examples import error_floor_campaign as efc
from ldpc_sims_tpu_torch.examples import quantized_llr_study as qls
from ldpc_sims_tpu_torch.examples import tanh_family
from ldpc_sims_tpu_torch.examples import train_edge_1944
from ldpc_sims_tpu_torch.examples import train_edge_layered_1944 as el
from ldpc_sims_tpu_torch.examples import train_minsum_1944
from ldpc_sims_tpu_torch.examples import train_minsum_short
from ldpc_sims_tpu_torch.examples import train_minsum_tail7
from ldpc_sims_tpu_torch.kernels import minsum_qc
from test_torch_examples import _digest_artifacts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(d) -> list[str]:
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _one(d, suffix) -> dict:
    (name,) = [f for f in os.listdir(d) if f.endswith(suffix)]
    return _load(os.path.join(d, name))


def _load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _quantized(mp, out):
    qls.main(num_codewords=64, epochs=1, out_prefix=str(out / "q"),
             device="cpu")
    assert sorted(os.listdir(out)) == ["q_ber.png", "q_wmse.png"]


def _tanh(mp, out):
    for k, v in dict(TANH_NUM_CW="64", TANH_EPOCHS="1", TANH_OUT=str(out),
                     TANH_DEVICE="cpu").items():
        mp.setenv(k, v)
    assert tanh_family.main() == 0
    rec = _one(out, "_tanh_family.json")
    assert set(rec) >= {"what", "qbits", "snr_db", "num_codewords",
                        "epochs", "arms"}
    assert set(rec["arms"]["tanh"]) == {"model", "final_train_loss",
                                        "ckpt", "curves"}
    assert "wmse_nn_flipped" in rec["arms"]["tanh"]["curves"]
    assert len(open(out / "registry.jsonl").readlines()) == 2
    assert sorted(os.listdir(out / "model")) == sorted(
        os.path.basename(a["ckpt"]) for a in rec["arms"].values())


def _minsum_1944(mp, out):
    mp.setattr(train_minsum_1944, "CODE", "wifi648")
    for k, v in dict(MS_ITERS="2", MS_BITS_PER_POINT="1",
                     MS_EVAL_BATCH="8", MS_TRAIN_STEPS="1",
                     MS_TRAIN_BATCH="8", MS_DEVICE="cpu",
                     MS_OUT=str(out / "m.json")).items():
        mp.setenv(k, v)
    assert train_minsum_1944.main() == 0
    rec = _load(out / "m.json")
    assert set(rec) >= {"what", "train", "alpha", "beta", "eval_batch",
                        "bits_per_point", "ber", "throughput"}
    assert set(rec["ber"]) == {"minsum_plain_layered10",
                               "minsum_trained_layered10",
                               "sumproduct_layered10",
                               "minsum_plain_flooding20"}
    assert len(rec["alpha"]) == 2


def _minsum_short(mp, out):
    for k, v in dict(MS_KS="2", MS_EVAL_BATCH="8", MS_EVAL_STEPS="1",
                     MS_TRAIN_STEPS="1", MS_TRAIN_BATCH="8",
                     MS_DEVICE="cpu", MS_OUT=str(out / "s.json")).items():
        mp.setenv(k, v)
    assert train_minsum_short.main() == 0
    rec = _load(out / "s.json")
    assert set(rec["arms"]) == {"flooding20", "trained_layered2"}
    arm = rec["arms"]["trained_layered2"]
    assert set(arm) >= {"alpha", "beta", "ber", "timing",
                        "parity_vs_flooding20"}
    copy = _load(out / "s_schedules.json")
    # the committed registry with the new entry merged, no floor_ok, its
    # npz paths relative to the copy
    assert copy["wifi1944"]["layered"]["2"] == {
        "alpha": arm["alpha"], "beta": arm["beta"],
        "parity_ok": arm["parity_vs_flooding20"]}
    del copy["wifi1944"]["layered"]["2"]
    assert copy == efc.relocate_registry(_load(efc.REGISTRY), ARTIFACTS, out)


def _tail7(mp, out):
    for name, v in dict(EVAL_BATCH=8, EVAL_STEPS=1, PROBE_BATCH=8).items():
        mp.setattr(train_minsum_tail7, name, v)
    for k, v in dict(T7_STEPS="1", T7_BATCH="8", T7_DEVICE="cpu",
                     T7_OUT=str(out / "t7.json")).items():
        mp.setenv(k, v)
    assert train_minsum_tail7.main() == 0
    rec = _load(out / "t7.json")
    assert set(rec) >= {"what", "steps", "batch", "lr", "alpha", "beta",
                        "bce", "probes", "guard_errs", "verdict"}
    assert set(rec["verdict"]) == {"1.75", "2.25", "2.75", "3.25"}
    # a copy only with every verdict passing, as the JAX script promotes
    assert ("t7_schedules.json" in os.listdir(out)) == all(
        rec["verdict"].values())


def _edge(mp, out):
    mp.setattr(train_edge_1944, "CODE", "wifi648")
    mp.setattr(train_edge_1944, "EVAL_BATCH", 8)
    for k, v in dict(EDGE_K="2", EDGE_STEPS="1", EDGE_BATCH="8",
                     EDGE_EVAL_STEPS="1", EDGE_DEVICE="cpu",
                     EDGE_OUT=str(out / "e.json")).items():
        mp.setenv(k, v)
    assert train_edge_1944.main() == 0
    rec = _load(out / "e.json")
    assert set(rec) >= {"what", "K", "steps", "batch", "train_snr_db",
                        "params", "bce", "ber"}
    assert set(rec["ber"]) == {"flooding-2 plain", "flooding-2 per-edge",
                               "flooding-20 plain"}


def _edge_layered(mp, out):
    for k, v in dict(EL_K="2", EL_STEPS="1", EL_BATCH="8",
                     EL_EVAL_BATCH="8", EL_EVAL_STEPS="1",
                     EL_FLOOR_STEPS="1", EL_PROBE_BATCH="8",
                     EL_DEVICE="cpu", EL_OUT=str(out / "el.json")).items():
        mp.setenv(k, v)
    assert el.main() == 0
    rec = _load(out / "el.json")
    assert set(rec) >= {"what", "K", "steps", "batch", "lr",
                        "train_snr_db", "params", "bce", "probes", "ber",
                        "pipe_bits_per_s", "parity_vs_flooding20",
                        "weights_npz"}
    assert set(rec["ber"]) == {"flooding-20", "layered-2 plain",
                               "layered-2 per-edge", "trained-layered-8"}
    assert sorted(os.listdir(out)) == ["el.json", "el.npz",
                                       "el_schedules.json"]
    copy = _load(out / "el_schedules.json")
    ent = copy["wifi1944"]["edge_layered"]["2"]
    assert ent["weights_npz"] == "el.npz" and len(ent["alpha"]) == 2
    # the copy's decoders, the committed ones too, load from its directory
    names = [n for n, _ in efc.schedules_from_registry(
        "wifi1944", copy, str(out), CPU)]
    assert [n for n in names if n.startswith("edge")] == [
        "edge-layered-2", "edge-layered-5", "edge-layered-6"]


@pytest.mark.parametrize("drive", [
    _quantized, _tanh, _minsum_1944, _minsum_short, _tail7, _edge,
    _edge_layered,
], ids=["quantized_llr_study", "tanh_family", "train_minsum_1944",
        "train_minsum_short", "train_minsum_tail7", "train_edge_1944",
        "train_edge_layered_1944"])
def test_examples_never_write_artifacts(drive, monkeypatch, tmp_path):
    """Each example writes only under its output path; nothing under
    docs/artifacts/ changes (C15)."""
    before = _digest_artifacts()
    out, cwd = tmp_path / "out", tmp_path / "cwd"
    out.mkdir()
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    drive(monkeypatch, out)
    assert _files(cwd) == []
    assert _digest_artifacts() == before


def test_edge_layered_copy_feeds_the_campaign(monkeypatch, tmp_path):
    """The registry copy and npz of ``train_edge_layered_1944``, read by
    the error-floor campaign through ``EF_REGISTRY``."""
    reg = tmp_path / "reg.json"
    reg.write_text(json.dumps({"wifi648": {"layered": {}}}))
    rec = el.run(CPU, str(tmp_path / "el" / "rec.json"), k=2, steps=1,
                 batch=8, eval_batch=8, eval_steps=1, floor_steps=1,
                 probe_batch=8, registry=str(reg), code="wifi648")
    assert "trained-layered-8" not in rec["ber"]
    copy = tmp_path / "el" / "rec_schedules.json"
    with open(copy) as f:
        names = [n for n, _ in efc.schedules_from_registry(
            "wifi648", json.load(f), str(tmp_path / "el"), CPU)]
    assert "edge-layered-2" in names
    for k, v in dict(EF_CODE="wifi648", EF_SNRS="2.0", EF_TARGET_BITS="1",
                     EF_BATCH="8", EF_CHUNK_STEPS="1", EF_DEVICE="cpu",
                     EF_ONLY="edge-layered-2", EF_REGISTRY=str(copy),
                     EF_OUT=str(tmp_path / "floor.json")).items():
        monkeypatch.setenv(k, v)
    assert efc.main() == 0
    with open(tmp_path / "floor.json") as f:
        points = json.load(f)["points"]
    assert [p["schedule"] for p in points] == ["flooding-20",
                                               "edge-layered-2"]


def test_tanh_family_arms_share_columns(tmp_path):
    rec = tanh_family.run(CPU, str(tmp_path), num_cw=64, epochs=1,
                          eval_codewords=64)
    plain, tanh = (rec["arms"][a]["curves"] for a in ("plain", "tanh"))
    for col in tanh_family.SHARED_COLUMNS:
        assert plain[col] == tanh[col], col
    assert plain["coded_ber_nn"] != tanh["coded_ber_nn"] or (
        plain["wmse_nn"] != tanh["wmse_nn"])


def test_quantized_llr_study_needs_matplotlib_first(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_data(*a, **k):
        raise AssertionError("data drawn before the matplotlib check")

    monkeypatch.setattr(qls, "make_llr_dataset", no_data)
    with pytest.raises(SystemExit, match="matplotlib"):
        qls.main(out_prefix=str(tmp_path / "q"), device="cpu")
    assert os.listdir(tmp_path) == []


def test_pallas_sumproduct_arithmetic(monkeypatch):
    """chip_smoke.py's ``pallas_sumproduct_excl`` (the JAX Pallas kernel's
    sum-product arithmetic, which reproduces the record's sum-product
    layered-10 at 2.0 dB) against that kernel in interpret mode on
    saturated wifi648 LLRs (one 128-lane tile, layered-2): the same
    posteriors in all but a few percent (a rounding of a ≈ 16.6 flips
    log(1 − e^−a) between 0 and −6e-8 there, and with it a magnitude
    between 28.3 and ~17), where the exact rule of the roll backend and
    the kernels differs in most."""
    import jax.numpy as jnp

    import chip_smoke
    from ldpc_sims_tpu.codes import get_code as jax_get_code
    from ldpc_sims_tpu.kernels.minsum_qc import bp_qc_pallas
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops import bp_roll

    rng = np.random.default_rng(3)
    llr = (rng.normal(14, 5, (128, 648))
           * np.where(rng.random((128, 648)) < 0.03, -1, 1)).astype(
               np.float32)
    kw = dict(iterations=2, schedule="layered", method="sum-product",
              output="posterior")
    ref = np.asarray(bp_qc_pallas(jnp.asarray(llr), jax_get_code(
        "wifi648").qc, interpret=True, **kw))
    qc, x = get_code("wifi648").qc, torch.from_numpy(llr)
    exact = bp_roll.decode_roll(x, qc, **kw).numpy()
    monkeypatch.setattr(bp_roll, "_sumproduct_excl",
                        chip_smoke.pallas_sumproduct_excl)
    pallas = bp_roll.decode_roll(x, qc, **kw).numpy()

    def share_out(got):
        return float(np.mean(np.abs(got - ref) > 1e-3 + 1e-3 * np.abs(ref)))

    assert share_out(pallas) < 0.1
    assert share_out(exact) > 0.5


def test_native_available():
    assert native.native_available() is True


def test_native_unavailable_without_compiler(monkeypatch, tmp_path):
    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    assert native.native_available() is False


def test_kernels_reexport_requeue():
    assert kernels.bp_qc_requeue is minsum_qc.bp_qc_requeue


# the JAX names the port gives another name, by module, and those it has
# no counterpart for: README's table
RENAMED = {
    "ldpc_sims_tpu.kernels.minsum_qc": {"bp_qc_pallas": "bp_qc_cuda",
                                        "minsum_qc_pallas": "minsum_qc_cuda",
                                        "default_tile": "default_threads"},
}
RENAMED["ldpc_sims_tpu.kernels"] = RENAMED["ldpc_sims_tpu.kernels.minsum_qc"]
ABSENT = {
    "ldpc_sims_tpu.parallel.mesh": {"batch_sharding", "replicated"},
    "ldpc_sims_tpu.parallel": {"batch_sharding", "replicated"},
    "ldpc_sims_tpu.utils.metrics": {"enable_compilation_cache"},
    "ldpc_sims_tpu.utils": {"enable_compilation_cache"},
}


def _defined_here(value, module: str) -> bool:
    """A function or class the module defines, also under ``jax.jit`` or
    ``functools.partial``."""
    if isinstance(value, functools.partial):
        value = value.func
    while True:
        if (inspect.isfunction(value) or inspect.isclass(value)) and (
                value.__module__ == module):
            return True
        if not hasattr(value, "__wrapped__"):
            return False
        value = value.__wrapped__


def _public_names(mod) -> set[str]:
    """``__all__``; else a package's re-exports; else what the module
    defines (names it merely imports do not count)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    names = {n for n, v in vars(mod).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    if hasattr(mod, "__path__"):
        return names
    return {n for n in names if _defined_here(getattr(mod, n),
                                              mod.__name__)}


def test_public_names_match_jax():
    with open(os.path.join(ROOT, "README.md")) as f:
        readme = f.read().splitlines()
    missing, checked = [], 0
    for info in pkgutil.walk_packages(ldpc_sims_tpu.__path__,
                                      "ldpc_sims_tpu."):
        if info.name.endswith("__main__") or info.name.endswith("libpeg"):
            continue
        mod = importlib.import_module(info.name)
        port = importlib.import_module(
            "ldpc_sims_tpu_torch" + info.name[len("ldpc_sims_tpu"):])
        renamed = RENAMED.get(info.name, {})
        for name in sorted(_public_names(mod)):
            checked += 1
            if name in ABSENT.get(info.name, ()):
                assert not hasattr(port, name), (info.name, name)
                continue
            if not hasattr(port, renamed.get(name, name)):
                missing.append(f"{info.name}.{name}")
    assert not missing, missing
    assert checked > 150  # the walk reached every module (183 names)
    # every rename and every name without a counterpart is a README row
    for name, new in RENAMED["ldpc_sims_tpu.kernels"].items():
        assert any(f"`{name}`" in line and f"`{new}`" in line
                   for line in readme), name
    for name in set().union(*ABSENT.values()):
        assert any(f"`{name}`" in line and "| — |" in line
                   for line in readme), name
