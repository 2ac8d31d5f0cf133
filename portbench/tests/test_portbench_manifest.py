"""BENCHMARK.json against the benchmark's files and its own rules, and the
imports of the benchmark's modules."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import check

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"]
    code = data["code"]
    assert len(code["base"]) * code["z"] == code["n"] - code["k"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert 1 <= len(cell["why"]) <= 200
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    dec = traffic["decoder"]
    assert (HERE / "roofline"
            / f"{dec['method']}-{dec['schedule']}.py").exists()
    assert set(traffic["limits"]) == set(check.NUMBERS)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


def test_cells_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(metric.get("workloads", cells)) <= cells


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "ldpc_sims_tpu",
                        "chip_smoke", "bench"}
    if "reference" in path.relative_to(HERE).parts:
        assert "ldpc_sims_tpu_torch" not in found
        assert "portbench" not in found


def test_whole_name_compare():
    # the port's name begins with the JAX package's: a prefix test would
    # flag it
    assert "ldpc_sims_tpu_torch".split(".")[0] != "ldpc_sims_tpu"
    from portbench import harness

    assert "ldpc_sims_tpu_torch" not in harness.forbidden_modules()
