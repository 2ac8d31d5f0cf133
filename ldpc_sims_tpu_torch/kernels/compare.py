"""Time the decode kernels of two checkouts of this package on one card.

    python -m ldpc_sims_tpu_torch.kernels.compare OLD_CHECKOUT NEW_CHECKOUT

Runs four turns in the order old, new, new, old. A turn is one process
that imports ``ldpc_sims_tpu_torch`` from one checkout (its root first on
``PYTHONPATH``), builds that checkout's kernels into its own ``build/``
and times each row below with CUDA events on inputs made from fixed
seeds: the same inputs for both checkouts. A row's time is the mean of
its two turns of a checkout. Each turn also hashes every row's output,
and the run fails unless both checkouts give the same bytes for every
row. Each turn also reports every entry point of its build: its SASS
instructions (``cuobjdump -sass``) and ptxas's registers and stack frame.
Prints the card, one JSON line per turn and a last JSON line
``{"rows": {name: {"old_ms", "new_ms", "ratio"}}, "sass": {entry point:
{"old", "new"}}, "sass_differ": [...], "ptxas_new": {...}, ...}``
(``sass`` the entry points of both builds, ``sass_differ`` those whose
size differs by more than 1%, ``ptxas_new`` the new build's (stack,
registers) of its entry points the old build lacks); exits 1 without a
card. ``COMPARE_ROWS`` (comma-separated row names) times those rows
alone.

The rows are the kernels' shapes on the main path and the bigcode run:
wifi1944 (QPSK/OFDM-32 channel LLRs) at batch 32768, qc8448_r12 and
qc12288_r12 at batch 16384 (LLRs ``N(0,1)·2 − 4``); each flooding form
of min-sum at each storage type, the layered forms, the two drivers; the
sum-product kernels' forms at wifi1944 (fixed, early stop, weighted,
4-bit messages, bf16 and int8 storage) and their four entry points at the
``wifi648-sweep`` preset's shape, wifi648 at 2.0 dB, batch 4096 and
32768; the group-serial forms (layered-20 at G = 1, 2, 3, 4, 6 and 12;
at G = 4, bf16 and int8, early stop, the K6 decoder's weights,
sum-product; wifi648 at batch 32768, G = 2 and 4; layered-10 at G = 2
and 4 on qc8448 and qc12288, batch 16384); the rate-2/3, 3/4 and 5/6
codes, rows of degree 8-18, at batch 32768: the committed TPU sweeps'
configuration of qc1944_r23, r34 and r56 (layered-20 early stop, clamp
20, QPSK/OFDM-32 at 3.749, 4.761 and 5.718 dB), the error-floor
campaign's three decoders (flooding-20, layered-10, the probe driver with
4 probe iterations and 20 in all) on qc1944_r34/r56 and qc648_r34/r56 at
its first SNR (all-zero codewords, BPSK, LLR = −2r/σ²), and flooding-20
and layered-20 on qc1944_r56 at bf16 and int8; on qc1944_r34 and r56 at
their TPU sweeps' points, min-sum layered-20 at G = 4 and 2 and with early
stop at G = 4, layered-6 with random weights at G = 4, and sum-product
layered-20, flooding-20, layered-20 with early stop and at G = 4.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

__all__ = ["floor_llrs", "main", "time_rows"]

SNRS = (1.5, 2.5, 3.0, 3.5)
# the committed TPU sweeps of the high-rate codes and the point each row
# takes (docs/artifacts/20260821_qc1944_r*_sweep_tpu.json)
HIGH_RATE_SWEEP = {"qc1944_r23": 3.749387366082999,
                   "qc1944_r34": 4.760912590556813,
                   "qc1944_r56": 5.718487496163564}
# the error-floor campaign's first SNR a code
# (docs/artifacts/20260821-11*_error_floor_qc*.json)
ERROR_FLOOR_SNR = {"qc1944_r34": 5.25, "qc1944_r56": 6.25,
                   "qc648_r34": 5.5, "qc648_r56": 6.5}


def _channel_llrs(code, batch: int, snrdb: float, seed: int):
    import torch

    from ldpc_sims_tpu_torch.ops import phy
    from ldpc_sims_tpu_torch.ops.encode import encode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    coded = encode(phy.random_bits(gen, (batch, code.k)), code)
    tx = phy.ofdm_modulate(phy.modulate_qpsk(coded).reshape(batch // 8, -1),
                           32)
    snr = 10.0 ** (snrdb / 10.0)
    rx = phy.awgn(gen, tx, snr)
    sym = phy.ofdm_demodulate(rx)
    return phy.demodulate_qpsk_llr(sym, snr).reshape(batch, code.n)


def floor_llrs(code, batch: int, snrdb: float, gen):
    """The error-floor campaign's channel (examples/error_floor_campaign.py:
    89-99), also that of the K6 and flooding training scripts: all-zero
    codewords, BPSK r = 1 + σ·n with σ = snr^-½, LLR = −2r/σ². ``gen`` is a
    CUDA ``torch.Generator`` to draw from, or a seed for a new one."""
    import torch

    if isinstance(gen, int):
        seed, gen = gen, torch.Generator(device="cuda")
        gen.manual_seed(seed)
    sigma = (10.0 ** (snrdb / 10.0)) ** -0.5
    r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                  device="cuda")
    return -2.0 * r / sigma**2


def _ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _digest(out) -> str:
    parts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_rows(root: str) -> dict:
    """{row: (ms, digest)} for the package under ``root``."""
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.convert import load_trained_schedule
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.ops import pack_decoder_weights
    from ldpc_sims_tpu_torch.utils import load_decoder_weights

    w1944 = get_code("wifi1944")
    qc = w1944.qc
    batch = 32768
    llr = {s: _channel_llrs(w1944, batch, s, seed=7 + int(10 * s))
           for s in SNRS}
    art = os.path.join(root, "docs", "artifacts")
    a8, b8 = load_trained_schedule(
        os.path.join(art, "minsum_trained_schedules.json"), "wifi1944", 8)
    k6 = load_decoder_weights(os.path.join(art, "edge_layered_1944_K6.npz"))
    k6p = pack_decoder_weights(k6, w1944, 6, "cuda")
    rng = np.random.default_rng(42)
    g = w1944.graph
    w12 = {k: rng.uniform(0.7, 1.3, s).astype(np.float32) for k, s in (
        ("w_msg", (12, g.n_vars, g.dv)), ("w_llr", (12, g.n_vars)),
        ("w_msg_final", (g.n_vars, g.dv)), ("w_llr_final", (g.n_vars,)))}
    w12p = pack_decoder_weights(w12, w1944, 12, "cuda")["tables"]
    big = get_code("qc12288_r12")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    xb = torch.randn((16384, big.n), generator=gen, device="cuda") * 2 - 4
    w648 = get_code("wifi648")
    x648 = {b: _channel_llrs(w648, b, 2.0, seed=20 + b // 4096)
            for b in (4096, 32768)}
    q8448 = get_code("qc8448_r12")
    x8448 = torch.randn((16384, q8448.n), generator=gen,
                        device="cuda") * 2 - 4

    high = {c: get_code(c) for c in HIGH_RATE_SWEEP}
    x_high = {c: _channel_llrs(high[c], batch, s, seed=15)
              for c, s in HIGH_RATE_SWEEP.items()}
    g34 = high["qc1944_r34"].graph
    w34 = {k: rng.uniform(0.7, 1.3, s).astype(np.float32) for k, s in (
        ("w_msg", (6, g34.n_vars, g34.dv)), ("w_llr", (6, g34.n_vars)),
        ("w_msg_final", (g34.n_vars, g34.dv)),
        ("w_llr_final", (g34.n_vars,)))}
    w34p = pack_decoder_weights(w34, high["qc1944_r34"], 6, "cuda")["tables"]
    floor = {c: get_code(c) for c in ERROR_FLOOR_SNR}
    x_floor = {c: floor_llrs(floor[c], batch, s, 91)
               for c, s in ERROR_FLOOR_SNR.items()}

    lay8 = dict(iterations=8, schedule="layered", alpha=a8, beta=b8)
    lay20 = dict(iterations=20, schedule="layered")
    cuda = mq.bp_qc_cuda

    def probe_chunk():
        bits, unsat = cuda(llr[3.5], qc, iterations=4, schedule="layered",
                           output="hard_unsat")
        cuda(llr[3.5], qc, done_in=unsat == 0, out=bits, **lay20)
        return bits

    # the codewords a flooding probe-4 leaves unsatisfied at 3.5 dB
    fl_bits, fl_unsat = cuda(llr[3.5], qc, iterations=4, output="hard_unsat")
    fl_done = fl_unsat == 0
    st = {"bf16": dict(dtype=torch.bfloat16, msg_qclip=24.0),
          "int8": dict(dtype=torch.int8, msg_qclip=24.0)}

    rows = {
        # the min-sum layered kernel's forms
        "minsum_qc_layered": lambda: cuda(llr[1.5], qc, **lay8),
        "minsum_qc_layered@bf16": lambda: cuda(
            llr[1.5], qc, dtype=torch.bfloat16, msg_qclip=24.0, **lay8),
        "minsum_qc_layered@int8": lambda: cuda(
            llr[1.5], qc, dtype=torch.int8, msg_qclip=24.0, **lay8),
        "minsum_qc_layered@es_auto": probe_chunk,
        "minsum_qc_layered@hard_unsat": lambda: cuda(
            llr[3.5], qc, iterations=4, schedule="layered",
            output="hard_unsat"),
        "minsum_qc_layered_es": lambda: cuda(
            llr[2.5], qc, early_stop=True, output="hard_iters", **lay20),
        "minsum_qc_layered_w": lambda: cuda(
            llr[1.5], qc, iterations=6, schedule="layered",
            weights=k6p["tables"], alpha=k6p["ms_alpha"],
            beta=k6p["ms_beta"]),
        # the group-serial forms
        **{f"minsum_qc_layered@g{G}": (lambda G=G: cuda(
            llr[1.5], qc, layered_group=G, **lay20))
           for G in (1, 2, 3, 4, 6, 12)},
        **{f"minsum_qc_layered@g4-{k}": (lambda kw=kw: cuda(
            llr[1.5], qc, layered_group=4, **lay20, **kw))
           for k, kw in st.items()},
        "minsum_qc_layered_es@g4": lambda: cuda(
            llr[2.5], qc, layered_group=4, early_stop=True,
            output="hard_iters", **lay20),
        "minsum_qc_layered_w@g4": lambda: cuda(
            llr[1.5], qc, iterations=6, schedule="layered", layered_group=4,
            weights=k6p["tables"], alpha=k6p["ms_alpha"],
            beta=k6p["ms_beta"]),
        "sumproduct_qc_layered@g4": lambda: cuda(
            llr[1.5], qc, method="sum-product", layered_group=4, **lay20),
        **{f"minsum_qc_layered@wifi648-g{G}": (lambda G=G: cuda(
            x648[32768], w648.qc, layered_group=G, **lay20)) for G in (2, 4)},
        **{f"minsum_qc_layered@{k}-g{G}": (lambda c=c, x=x, G=G: cuda(
            x, c.qc, iterations=10, schedule="layered", layered_group=G))
           for k, c, x in (("qc8448", q8448, x8448), ("qc12288", big, xb))
           for G in (2, 4)},
        **{f"minsum_qc_layered@qc12288{sfx}": (lambda dt=dt: cuda(
            xb, big.qc, iterations=10, schedule="layered", dtype=dt,
            msg_qclip=24.0))
           for sfx, dt in (("", torch.float32), ("-bf16", torch.bfloat16),
                           ("-int8", torch.int8))},
        # the two drivers over the layered kernel
        **{f"bp_qc_requeue@{s:g}": (lambda s=s: mq.bp_qc_requeue(
            llr[s], qc, 20, probe_iters=4, es_check_every=1,
            schedule="layered", output="hard_iters")) for s in (2.5, 3.0)},
        **{f"bp_qc_probe_requeue@{s:g}": (lambda s=s: mq.bp_qc_probe_requeue(
            llr[s], qc, 20, probe_iters=4, output="hard_iters"))
           for s in (2.5, 3.0)},
        # the min-sum flooding kernel's forms
        "minsum_qc_flooding": lambda: cuda(llr[1.5], qc, iterations=20),
        **{f"minsum_qc_flooding@{k}": (lambda kw=kw: cuda(
            llr[1.5], qc, iterations=20, **kw)) for k, kw in st.items()},
        "minsum_qc_flooding@hard_unsat": lambda: cuda(
            llr[1.5], qc, iterations=20, output="hard_unsat"),
        "minsum_qc_flooding@done_in": lambda: cuda(
            llr[3.5], qc, iterations=20, done_in=fl_done, out=fl_bits),
        "minsum_qc_flooding_es": lambda: cuda(
            llr[2.5], qc, iterations=20, early_stop=True,
            output="hard_iters"),
        "minsum_qc_flooding_es@msgq4": lambda: cuda(
            llr[2.5], qc, iterations=20, early_stop=True,
            output="hard_iters", msg_qbits=4),
        "minsum_qc_flooding@msgq4": lambda: cuda(llr[1.5], qc, iterations=20,
                                                 msg_qbits=4),
        "minsum_qc_flooding_w": lambda: cuda(llr[1.5], qc, iterations=12,
                                             weights=w12p),
        "minsum_qc_flooding_w@msgq4": lambda: cuda(
            llr[1.5], qc, iterations=12, weights=w12p, msg_qbits=4),
        "minsum_qc_flooding@qc12288": lambda: cuda(xb, big.qc,
                                                   iterations=20),
        **{f"minsum_qc_flooding@qc12288-{k}": (lambda kw=kw: cuda(
            xb, big.qc, iterations=20, **kw)) for k, kw in st.items()},
        "minsum_qc_flooding@qc8448": lambda: cuda(x8448, q8448.qc,
                                                  iterations=20),
        # the sum-product kernels' forms
        "sumproduct_qc_flooding": lambda: cuda(
            llr[1.5], qc, iterations=20, method="sum-product"),
        "sumproduct_qc_layered": lambda: cuda(
            llr[1.5], qc, method="sum-product", **lay20),
        "sumproduct_qc_flooding_es": lambda: cuda(
            llr[2.5], qc, iterations=20, method="sum-product",
            early_stop=True, output="hard_iters"),
        "sumproduct_qc_layered_es": lambda: cuda(
            llr[2.5], qc, method="sum-product", early_stop=True,
            output="hard_iters", **lay20),
        **{f"sumproduct_qc_{s}_w": (lambda s=s: cuda(
            llr[1.5], qc, iterations=12, schedule=s, method="sum-product",
            weights=w12p)) for s in ("flooding", "layered")},
        **{f"sumproduct_qc_{s}@{k}": (lambda s=s, kw=kw: cuda(
            llr[1.5], qc, iterations=20, schedule=s, method="sum-product",
            **kw))
           for s in ("flooding", "layered")
           for k, kw in (("msgq4", dict(msg_qbits=4)), *st.items())},
        # the high-rate codes (rows of degree 8-18): the TPU sweeps' rows
        **{f"minsum_qc_layered_es@{c}": (lambda c=c: cuda(
            x_high[c], high[c].qc, clamp=20.0, early_stop=True,
            output="hard_iters", **lay20)) for c in HIGH_RATE_SWEEP},
        # the error-floor campaign's decoders
        **{f"minsum_qc_flooding@{c}": (lambda c=c: cuda(
            x_floor[c], floor[c].qc, iterations=20)) for c in ERROR_FLOOR_SNR},
        **{f"minsum_qc_layered@{c}": (lambda c=c: cuda(
            x_floor[c], floor[c].qc, iterations=10, schedule="layered"))
           for c in ERROR_FLOOR_SNR},
        **{f"bp_qc_probe_requeue@{c}": (lambda c=c: mq.bp_qc_probe_requeue(
            x_floor[c], floor[c].qc, 20, probe_iters=4, output="hard_iters"))
           for c in ERROR_FLOOR_SNR},
        # qc1944_r56's storage types: flooding-20 and layered-20
        **{f"minsum_qc_flooding@qc1944_r56-{k}": (lambda kw=kw: cuda(
            x_floor["qc1944_r56"], floor["qc1944_r56"].qc, iterations=20,
            **kw)) for k, kw in st.items()},
        **{f"minsum_qc_layered@qc1944_r56-l20{sfx}": (lambda kw=kw: cuda(
            x_floor["qc1944_r56"], floor["qc1944_r56"].qc, **lay20, **kw))
           for sfx, kw in (("", {}), *((f"-{k}", v) for k, v in st.items()))},
        # the group-serial min-sum and the sum-product forms on the
        # high-rate codes, at the TPU sweeps' points
        **{f"minsum_qc_layered@qc1944_r34-g{G}": (lambda G=G: cuda(
            x_high["qc1944_r34"], high["qc1944_r34"].qc, layered_group=G,
            **lay20)) for G in (4, 2)},
        "minsum_qc_layered_es@qc1944_r56-g4": lambda: cuda(
            x_high["qc1944_r56"], high["qc1944_r56"].qc, layered_group=4,
            early_stop=True, output="hard_iters", **lay20),
        "minsum_qc_layered_w@qc1944_r34-g4": lambda: cuda(
            x_high["qc1944_r34"], high["qc1944_r34"].qc, iterations=6,
            schedule="layered", layered_group=4, weights=w34p),
        **{f"sumproduct_qc_{s}@qc1944_r56": (lambda s=s: cuda(
            x_high["qc1944_r56"], high["qc1944_r56"].qc, iterations=20,
            schedule=s, method="sum-product"))
           for s in ("layered", "flooding")},
        "sumproduct_qc_layered_es@qc1944_r34": lambda: cuda(
            x_high["qc1944_r34"], high["qc1944_r34"].qc, method="sum-product",
            early_stop=True, output="hard_iters", **lay20),
        "sumproduct_qc_layered@qc1944_r34-g4": lambda: cuda(
            x_high["qc1944_r34"], high["qc1944_r34"].qc, method="sum-product",
            layered_group=4, **lay20),
        # the wifi648-sweep preset's code and SNR
        **{f"sumproduct_qc_{s}{es}@wifi648-{b}": (
            lambda s=s, es=es, x=x648[b]: cuda(
                x, w648.qc, iterations=20, schedule=s, method="sum-product",
                early_stop=bool(es),
                output="hard_iters" if es else "hard"))
           for b in x648 for s in ("flooding", "layered")
           for es in ("", "_es")},
    }
    only = os.environ.get("COMPARE_ROWS")
    if only:
        names = only.split(",")
        unknown = sorted(set(names) - set(rows))
        if unknown:
            raise SystemExit(f"COMPARE_ROWS: no rows {unknown}")
        rows = {k: rows[k] for k in names}
    out = {}
    for name, fn in rows.items():
        digest = _digest(fn())
        reps = 10 if ("qc12288" in name or "sumproduct" in name
                      or "flooding" in name) else 20
        out[name] = (_ms(fn, reps), digest)
    return out


def entry_points(lib: str, report: str) -> dict:
    """{entry point: [SASS instructions, stack frame bytes, registers]} of
    a built library, from ``cuobjdump -sass`` and ptxas's -v report. An
    entry point is named by its mangled name up to its first parameter:
    the rest names the plan structs' anonymous namespace, whose mangling
    differs between two builds of the source."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        out[block.split()[0].split("PKf")[0]] = [
            len(re.findall(r"/\*[0-9a-f]{4,}\*/\s", block)), None, None]
    name = stack = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, stack = m.group(1).split("PKf")[0], None
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name is not None:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][1:] = [stack, int(m.group(1))]
            name = None
    return out


def _turn() -> None:
    import torch

    import ldpc_sims_tpu_torch

    root = os.environ["COMPARE_ROOT"]
    if not os.path.abspath(ldpc_sims_tpu_torch.__file__).startswith(
            os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {ldpc_sims_tpu_torch.__file__}, not "
                         f"the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

    lib, report = mq.build()
    print(json.dumps({"root": root, "rows": time_rows(root),
                      "entries": entry_points(str(lib), report)}),
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--turn"]:
        _turn()
        return 0
    import torch

    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    old, new = (os.path.abspath(a) for a in argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    turns = {old: [], new: []}
    entries = {}
    for root in (old, new, new, old):
        env = dict(os.environ, COMPARE_ROOT=root, PYTHONPATH=root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn"], cwd=root, env=env,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns[root].append(json.loads(line)["rows"])
        entries[root] = json.loads(line)["entries"]
    summary, differ = {}, []
    for name in turns[new][0]:
        o = [t[name][0] for t in turns[old]]
        n = [t[name][0] for t in turns[new]]
        digests = {t[name][1] for t in turns[old] + turns[new]}
        if len(digests) != 1:
            differ.append(name)
        summary[name] = {"old_ms": statistics.mean(o),
                         "new_ms": statistics.mean(n),
                         "ratio": statistics.mean(o) / statistics.mean(n),
                         "old_turns": o, "new_turns": n}
    both = sorted(set(entries[old]) & set(entries[new]))
    sass = {k: {"old": entries[old][k][0], "new": entries[new][k][0]}
            for k in both}
    print(json.dumps({
        "card": card, "rows": summary, "outputs_differ": differ,
        "sass": sass,
        "sass_differ": [k for k, v in sass.items()
                        if abs(v["new"] - v["old"]) > 0.01 * v["old"]],
        "ptxas_new": {k: v[1:] for k, v in entries[new].items()
                      if k not in entries[old]}}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
