"""Code analysis, ``code-info`` and the process-stable seed fold against the
JAX package (CPU).

* ``code_report`` (degree profiles, the QC 4-/6-cycle spectrum) equals
  JAX's dict exactly on every library code but qc8448/qc12288 (built in
  files of their own), and on JAX's bad base ``[[0, 1], [0, 1]]`` at z=4.
* ``code-info`` on a ``--base-file`` shift table and on an ``--alist``
  prints JAX's JSON.
* ``stable_fold_in``: the integer the port folds (``fold_tag``) is the one
  JAX folds into its key, for numeric and str parts; the port's seed is
  the same in two processes with different PYTHONHASHSEED.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.codes.analyze import code_report as jax_code_report
from ldpc_sims_tpu.codes.analyze import qc_cycle_counts as jax_qc_cycles
from ldpc_sims_tpu.utils.metrics import stable_fold_in as jax_fold_in
from ldpc_sims_tpu_torch.codes import get_code, list_codes
from ldpc_sims_tpu_torch.codes.analyze import code_report, qc_cycle_counts
from ldpc_sims_tpu_torch.utils.metrics import (
    fold_seed,
    fold_tag,
    stable_fold_in,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARY = [c for c in list_codes() if not c.startswith(("qc8448", "qc12288"))]


@pytest.mark.parametrize("name", LIBRARY)
def test_code_report_matches_jax(name):
    ours = code_report(get_code(name))
    theirs = jax_code_report(jax_get_code(name))
    assert ours == theirs
    assert json.dumps(ours) == json.dumps(theirs)  # key order too


def test_bad_base_cycles_match_jax():
    bad = np.array([[0, 1], [0, 1]])
    ours = qc_cycle_counts(bad, 4)
    assert ours == jax_qc_cycles(bad, 4)
    assert ours["cycles_4"] == 4 and ours["girth_lower_bound"] == 4


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_code_info_base_file_and_alist_match_jax(tmp_path):
    from ldpc_sims_tpu.cli.main import main as jax_main
    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.codes import save_alist

    # a shift table in load_qc_base's format: qc648_r34's base at z = 27
    qc = get_code("qc648_r34").qc
    base = tmp_path / "base.txt"
    base.write_text(f"# qc648_r34\n{qc.z}\n" + "".join(
        " ".join(str(s) for s in row) + "\n" for row in qc.base))
    alist = str(tmp_path / "peg.alist")
    save_alist(alist, get_code("peg128_64"))
    for flags in (["--base-file", str(base)], ["--alist", alist],
                  ["--code", "wifi648"]):
        ours = json.loads(_stdout(cli_main,
                                  ["code-info", *flags, "--device", "cpu"]))
        theirs = json.loads(_stdout(jax_main, ["code-info", *flags]))
        assert ours == theirs, flags
    assert ours["qc"]["base_shape"] == [12, 24]


PARTS = [(5.0, 3, 1.0), (0.0, 1, 10 ** 0.5), ("unquantized", 2, 0.0),
         ("snr=2", "qbits=3"), (np.float64(2.5), np.int64(7)), ()]


@pytest.mark.parametrize("parts", PARTS)
def test_fold_tag_is_what_jax_folds(parts):
    key = jax.random.key(11)
    want = jax.random.key_data(jax_fold_in(key, *parts))
    got = jax.random.key_data(jax.random.fold_in(key, fold_tag(*parts)))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    seed = stable_fold_in(11, *parts)
    assert seed == fold_seed(11, fold_tag(*parts))
    assert 0 <= seed < 2**63


def test_stable_fold_in_differs_from_stable_seed():
    from ldpc_sims_tpu_torch.parallel.mc import stable_seed

    assert stable_fold_in(0, 5.0, 3, 1.0) != stable_seed(0, 5.0, 3, 1.0)
    assert stable_fold_in(0, 5.0, 3) != stable_fold_in(1, 5.0, 3)
    assert stable_fold_in(0, 5.0, 3) != stable_fold_in(0, 5.0, 4)


def test_stable_fold_in_is_process_stable():
    code = ("from ldpc_sims_tpu_torch.utils.metrics import stable_fold_in;"
            "print(stable_fold_in(3, 'quantized', 2.0, 3, 'x'))")
    outs = []
    for hashseed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed, PYTHONPATH=ROOT)
        outs.append(subprocess.run(
            [sys.executable, "-c", code], env=env, capture_output=True,
            text=True, check=True, timeout=120).stdout.strip())
    assert outs[0] == outs[1] == str(stable_fold_in(3, "quantized", 2.0, 3,
                                                    "x"))
