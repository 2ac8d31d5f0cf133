"""The frozen bound against the times PERF.md section 6 gives at batch
32768 (chip_smoke.py's formula on the H100 SXM peaks)."""

import json
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3"


def _bound_ms(config: str, traffic: str, iterations_run=None,
              **decoder) -> float:
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr["decoder"].update(decoder)
    ctx = {"config": cfg, "traffic": tr, "batch": 32768,
           "iterations_run": iterations_run, "device": {"kind": CARD}}
    return harness._bound(ctx)["ms"]


@pytest.mark.parametrize("config, traffic, ran, decoder, want", [
    ("wifi1944-qpsk-ofdm32", "ms-flood20.es1.5", None, {}, 1.226),
    ("wifi1944-qpsk-ofdm32", "ms-layered8-trained.es1.5", None, {}, 0.709),
    ("wifi1944-qpsk-ofdm32", "sp-flood20.es1.5", None, {}, 20.850),
    # minsum_qc_layered_es: layered-20, no clamp, 4.42 mean iterations
    ("wifi1944-qpsk-ofdm32", "ms-layered20-es.es3.5", 4.42 * 32768,
     {"clamp": None}, 0.375),
])
def test_bound_reproduces_perf_md(config, traffic, ran, decoder, want):
    assert _bound_ms(config, traffic, ran, **decoder) == pytest.approx(
        want, abs=6e-4)


def test_unknown_card_has_no_bound():
    cfg = json.loads((HERE / "configs" / "wifi1944-qpsk-ofdm32.json")
                     .read_text())
    tr = json.loads((HERE / "traffic" / "ms-flood20.es1.5.json").read_text())
    ctx = {"config": cfg, "traffic": tr, "batch": 32768,
           "iterations_run": None, "device": {"kind": "cpu"}}
    assert harness._bound(ctx) is None
