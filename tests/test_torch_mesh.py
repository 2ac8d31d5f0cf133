"""The port's process mesh and its sharded Monte-Carlo engine (CPU).

* ``make_mesh`` shapes and errors (the pattern of
  ``tests/test_parallel.py``), ``maybe_distributed_init`` without a
  launcher's environment, ``local_batch_multiple``.
* A one-rank mesh draws the mesh-less stream: ``mc_step`` equals
  ``link_step`` on the seed itself, bit for bit.
* ``run_grid`` equals per-point ``mc_step`` calls with the derived seeds,
  and in probe mode runs the probe driver once a point (ROADMAP C4: the
  JAX package vmaps the grid, so both branches of its overflow cond run).
* ``scaling_probe`` returns one row on one process.
* Two processes on Gloo (subprocesses and a free port, the pattern of
  ``tests/test_multihost.py``): the same global BER on both ranks, the
  manifest and the CLI's files written by rank 0 alone (C8), the
  ``es_mode='auto'`` choice rank 0's on both (C9), the two-rank
  ``mc_step`` the sum of its two shards, ``run_grid`` over each axis,
  ``scaling_probe`` over 1 and 2 ranks, ``evaluate_sweep`` on the mesh.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
from ldpc_sims_tpu_torch.parallel import (
    Mesh,
    local_batch_multiple,
    make_mesh,
    maybe_distributed_init,
    mc_step,
    run_grid,
    scaling_probe,
)
from ldpc_sims_tpu_torch.parallel.mc import (
    _COUNT_KEYS,
    shard_seed,
    stable_seed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINSUM3 = LinkConfig(bp_iterations=3, bp_method="min-sum", clamp=None)


def _counts(out):
    return {k: int(out[k]) for k in _COUNT_KEYS}


def test_mesh_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_distributed_init() is False
    mesh = make_mesh()
    assert mesh.shape == {"snr": 1, "batch": 1}
    assert mesh.axis_names == ("snr", "batch")
    assert local_batch_multiple(mesh) == 1 and mesh.group is None
    assert mesh.index == 0 and mesh.coords == (0, 0) and mesh.is_leader
    with pytest.raises(ValueError, match="not divisible by 2"):
        make_mesh(snr_axis=2)
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(ranks=[0, 1])


def test_mesh_shapes_and_batch_divisibility():
    """A mesh of 8 ranks laid out by hand (no process group is needed to
    hold the layout): shapes, shard indices, and mc_step's and run_grid's
    divisibility errors, JAX's."""
    mesh = Mesh(np.arange(8).reshape(2, 4), None, 6)
    assert mesh.shape == {"snr": 2, "batch": 4}
    assert local_batch_multiple(mesh) == 8
    assert mesh.index == 6 and mesh.coords == (1, 2) and not mesh.is_leader
    code = get_code("ref6432")
    with pytest.raises(ValueError, match="divisible"):
        mc_step(code, LinkConfig(), batch_cw=100, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="grid size 3 not divisible"):
        run_grid(code, LinkConfig(), (1.0, 2.0, 3.0), 64, mesh=mesh,
                 device="cpu")
    with pytest.raises(ValueError, match="cw_per_point 66 not divisible"):
        run_grid(code, LinkConfig(), (1.0, 2.0), 66, mesh=mesh,
                 device="cpu")
    with pytest.raises(ValueError, match="rank 9 is not in the mesh"):
        Mesh(np.arange(8).reshape(2, 4), None, 9).index


def test_one_rank_mesh_draws_the_meshless_stream():
    code = get_code("wifi648")
    seed = 1234
    got = mc_step(code, MINSUM3, 64, mesh=make_mesh(), device="cpu")(seed,
                                                                     2.0)
    gen = torch.Generator().manual_seed(seed)
    want = link_step(gen, 2.0, code, MINSUM3, 64)
    assert _counts(got) == _counts(want)
    assert shard_seed(seed, 0, 1) == seed
    assert shard_seed(seed, 0, 2) != shard_seed(seed, 1, 2) != seed


def test_run_grid_equals_per_point_mc_step():
    code = get_code("wifi648")
    grid = (1.5, 2.5, 3.5)
    got = run_grid(code, MINSUM3, grid, 64, seed=5, device="cpu")
    step = mc_step(code, MINSUM3, 64, device="cpu")
    for p, snr in enumerate(grid):
        want = _counts(step(stable_seed(5, p), snr))
        assert {k: int(got[k][p]) for k in _COUNT_KEYS} == want
    assert got["frames"].tolist() == [64, 64, 64]
    assert got["coded_bit_errors"][0] > got["coded_bit_errors"][2]


def test_run_grid_probe_runs_one_branch(monkeypatch):
    """C4, settled: each grid point is its own decode, so the probe driver
    runs once a point, its probe and its done_in pass (two decodes), and
    never a second, full-batch overflow decode beside them."""
    code = get_code("wifi648")
    cfg = LinkConfig(bp_iterations=6, bp_method="min-sum", clamp=None,
                     bp_schedule="layered", early_stop=True,
                     es_mode="probe", es_probe_iters=2)
    calls = {"driver": 0, "decode": []}
    driver, decode = mq.bp_qc_probe_requeue, mq.bp_qc_cuda

    def count_driver(*a, **kw):
        calls["driver"] += 1
        return driver(*a, **kw)

    def count_decode(llr, *a, **kw):
        calls["decode"].append((llr.shape[0], "done_in" in kw))
        return decode(llr, *a, **kw)

    monkeypatch.setattr(mq, "bp_qc_probe_requeue", count_driver)
    monkeypatch.setattr(mq, "bp_qc_cuda", count_decode)
    grid = (2.0, 3.0)
    got = run_grid(code, cfg, grid, 64, seed=2, device="cpu")
    assert calls["driver"] == 2
    assert calls["decode"] == [(64, False), (64, True)] * 2
    step = mc_step(code, cfg, 64, device="cpu")
    for p, snr in enumerate(grid):
        assert ({k: int(got[k][p]) for k in _COUNT_KEYS}
                == _counts(step(stable_seed(2, p), snr)))


def test_scaling_probe_one_process():
    out = scaling_probe(get_code("wifi648"), MINSUM3, per_dev_cw=64,
                        device_counts=(1, 2, 4, 8), steps=2, device="cpu")
    assert out["devices"] == [1]
    assert out["efficiency"] == [1.0]
    assert out["bits_per_s"][0] > 0 and 0 <= out["host_frac"][0] < 1
    assert (out["per_dev_cw"], out["steps"]) == (64, 2)


WORKER = textwrap.dedent(
    """
    import json, os, sys, time, warnings
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ.update(WORLD_SIZE="2", RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
    from ldpc_sims_tpu_torch.parallel import mc, mesh as mesh_mod
    from ldpc_sims_tpu_torch.parallel import (
        SweepConfig, make_mesh, maybe_distributed_init, mc_step, run_grid,
        run_sweep, scaling_probe)
    from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
    from ldpc_sims_tpu_torch.cli.main import main as cli_main

    res = {"rank": rank}
    assert maybe_distributed_init()
    res["backend"] = dist.get_backend()
    res["shapes"] = [make_mesh().shape, make_mesh(snr_axis=2).shape]
    try:
        make_mesh(snr_axis=3)
    except ValueError as e:
        res["error"] = str(e)
    keys = mc._COUNT_KEYS

    # the reference chain: the same global BER on both ranks; the
    # manifest written by rank 0 alone
    writes = []
    real_replace = os.replace
    def replace(src, dst):
        writes.append(dst)
        return real_replace(src, dst)
    os.replace = replace
    code = get_code("ref6432")
    link = LinkConfig(bp_iterations=3, bp_method="sum-product-ref",
                      clamp=20.0)
    sweep = SweepConfig(snrdb=(3.0,), batch_cw=512,
                        target_frame_errors=50, max_info_bits=1e5)
    r = run_sweep(code, link, sweep, log=None,
                  manifest_path=os.path.join(out, "manifest.json"),
                  device="cpu")
    os.replace = real_replace
    res["coded_ber"] = r.coded_ber[0]
    res["frames"] = r.frames[0]
    res["manifest_writes"] = len(writes)

    # the two-rank step is the sum of its two shards
    w648 = get_code("wifi648")
    ms3 = LinkConfig(bp_iterations=3, bp_method="min-sum", clamp=None)
    got = mc_step(w648, ms3, 64, device="cpu")(77, 2.0)
    want = {k: 0 for k in keys}
    for i in range(2):
        g = torch.Generator().manual_seed(mc.shard_seed(77, i, 2))
        o = link_step(g, 2.0, w648, ms3, 32)
        for k in keys:
            want[k] += int(o[k])
    res["step_is_shard_sum"] = {k: int(got[k]) for k in keys} == want

    # es_mode='auto': rank 0's clocks prefer probe (its timed fixed call
    # sleeps), rank 1's prefer fixed (its timed probe call sleeps)
    real_step = mc.mc_step
    def slow_step(code, cfg, *a, **kw):
        run = real_step(code, cfg, *a, **kw)
        mode = "probe" if cfg.es_mode == "probe" else "fixed"
        calls = []
        def timed(seed, snr):
            o = run(seed, snr)
            calls.append(1)
            if len(calls) == 2 and mode == ("fixed", "probe")[rank]:
                time.sleep(1.0)
            return o
        return timed
    mc.mc_step = slow_step
    class Events:
        def __init__(self):
            self.auto, self.modes = [], []
        def log(self, event, **f):
            if event == "es-auto":
                self.auto.append(f)
            elif event == "sweep-step":
                self.modes.append(f["mode"])
    ev = Events()
    auto = LinkConfig(bp_iterations=6, bp_method="min-sum", clamp=None,
                      bp_schedule="layered", early_stop=True,
                      es_mode="auto", es_probe_iters=2)
    run_sweep(w648, auto, SweepConfig(snrdb=(2.5,), batch_cw=64,
              target_frame_errors=10**9, min_info_bits=0,
              max_info_bits=6 * 64 * 324), log=None, metrics=ev,
              device="cpu")
    mc.mc_step = real_step
    a = ev.auto[0]
    res["auto_chosen"] = a["mode"]
    res["auto_local"] = min(("fixed", "probe"), key=a.get)
    res["auto_modes"] = ev.modes

    # run_grid over the snr axis (a point a rank) and the batch axis
    one = mesh_mod.Mesh(np.array([[rank]]), None, rank)
    for snr_axis in (2, 1):
        grid = run_grid(w648, ms3, (1.5, 3.0), 64,
                        mesh=make_mesh(snr_axis=snr_axis), seed=4,
                        device="cpu")
        step = mc_step(w648, ms3, 64, device="cpu",
                       mesh=one if snr_axis == 2 else None)
        same = True
        for p, snr in enumerate((1.5, 3.0)):
            o = step(mc.stable_seed(4, p), snr)
            same &= all(int(o[k]) == int(grid[k][p]) for k in keys)
        res[f"grid_snr{snr_axis}"] = same

    res["probe"] = scaling_probe(w648, ms3, per_dev_cw=32,
                                 device_counts=(1, 2, 4), steps=2,
                                 device="cpu")["devices"]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ec = EvalConfig(snrdb=(2.0,), num_codewords=64, seed=3)
        res["eval"] = evaluate_sweep(w648, ms3, ec, log=None, device="cpu")
        res["eval_fallback"] = evaluate_sweep(
            w648, ms3, EvalConfig(snrdb=(2.0,), num_codewords=24, seed=3),
            log=None, device="cpu")
    res["warned"] = any("single shard" in str(w.message) for w in caught)

    # the CLI last: it joins the live group and closes it
    cli_main(["sweep", "--multihost", "--code", "ref6432", "--snr", "3",
              "--batch", "256", "--max-bits", "2e4", "--device", "cpu",
              "--out", os.path.join(out, "cli")])
    res["closed"] = not dist.is_initialized()
    print("RESULT " + json.dumps(res), flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sweep(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), port, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=str(tmp_path))
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    r0, r1 = (json.loads(line.split("RESULT ", 1)[1])
              for out in outs for line in out.splitlines()
              if line.startswith("RESULT "))
    for r in (r0, r1):
        assert r["backend"] == "gloo"
        assert r["shapes"] == [{"snr": 1, "batch": 2},
                               {"snr": 2, "batch": 1}]
        assert r["error"] == "2 ranks not divisible by 3"
        assert r["step_is_shard_sum"]
        assert r["grid_snr2"] and r["grid_snr1"]
        assert r["probe"] == [1, 2]
        assert r["warned"] and r["closed"]
    # the summed counts: the same global BER and stopping on both ranks,
    # and it is the reference chain's (table A @3 dB: 1.142e-2)
    assert r0["coded_ber"] == r1["coded_ber"]
    assert r0["frames"] == r1["frames"]
    assert np.isclose(r0["coded_ber"], 1.142e-2, rtol=0.35)
    # C8: rank 0 alone writes the manifest
    assert r0["manifest_writes"] >= 1 and r1["manifest_writes"] == 0
    # C9: the clocks disagreed and both ranks decoded rank 0's choice
    assert r0["auto_local"] == "probe" and r1["auto_local"] == "fixed"
    assert r0["auto_chosen"] == r1["auto_chosen"] == "probe"
    assert r0["auto_modes"] == r1["auto_modes"]
    assert r0["eval"] == r1["eval"]
    assert r0["eval_fallback"] == r1["eval_fallback"]
    cli = tmp_path / "cli"
    files = sorted(os.listdir(cli))
    assert [f for f in files if f.endswith("_curves.json")] and len(
        [f for f in files if f.endswith("_curves.json")]) == 1
    with open(cli / "registry.jsonl") as f:
        assert len(f.readlines()) == 1
    with open(cli / "metrics.jsonl") as f:
        events = [json.loads(line)["event"] for line in f]
    assert events.count("sweep-point") == 1
    assert "distributed: backend gloo, world 2" in outs[0]
