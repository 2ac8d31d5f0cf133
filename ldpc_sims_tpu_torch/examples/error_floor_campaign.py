"""Error-floor campaign for every headline decode schedule (the port of the
JAX package's ``examples/error_floor_campaign.py``).

Trained offset/scale min-sum schedules (several committed betas are
negative) can develop an error floor at BER ≤ 1e-7 where the plain
decoder does not. This campaign runs each schedule against the
flooding-20 control on PAIRED noise deep into the floor region:

  schedules: flooding-20 (control), layered-10, every committed trained
             layered-K and its ``probe-trained{K}-20`` composite, the
             per-edge ``edge-layered-K`` decoders of the committed
             ``.npz`` files, and ``probe-plain4-20``, as listed in the
             trained-schedule registry
             (``docs/artifacts/minsum_trained_schedules.json``);
  points:    $EF_SNRS dB (default 2.5, 3.0, 3.5; Es/N0 of the BPSK-AWGN
             channel, all-zero codewords, LLR = −2r/σ²);
  budget:    ≥ $EF_TARGET_BITS info bits per (schedule, point) (default
             1e11), with an early break once $EF_MAX_ERRS bit errors are
             seen.

The frames of step ``s`` at point ``p`` come from a generator seeded with
``stable_seed(20260821, p, s)``: a function of (point, step) only, so
every schedule decodes the same frames. A chunk of $EF_CHUNK_STEPS decodes
accumulates its int64 error counts on the device and is read once.

Verdict per (schedule, point): floor_ok iff the schedule's bit-error count
does not exceed the paired control's (scaled to its exposure) by more
than 15% plus 5·√control + 20. The record goes to $EF_OUT (default
``outputs/<stamp>_error_floor[_<code>].json``; resumable: $EF_RESUME=<path>
extends an earlier record, $EF_CTRL_FROM=<path> imports its control
points). The folded floor_ok flags go into a copy of the registry beside
the record (``<record>_schedules.json``): the committed registry and
everything under ``docs/artifacts/`` are read, never written.

Run:  python -m ldpc_sims_tpu_torch.examples.error_floor_campaign
Env:  EF_CODE (wifi1944), EF_SNRS, EF_TARGET_BITS, EF_ONLY (comma list of
      schedules besides the control), EF_MAX_ERRS (2e6), EF_BATCH (32768),
      EF_CHUNK_STEPS (32), EF_REGISTRY (the committed registry),
      EF_DEVICE (cuda; cpu runs the plain version), EF_OUT, EF_RESUME,
      EF_CTRL_FROM.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.examples.paired import bpsk_llrs
from ldpc_sims_tpu_torch.ops.bp import bp_decode, pack_decoder_weights
from ldpc_sims_tpu_torch.parallel.mc import stable_seed
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["floor_verdicts", "fold_registry", "main", "point_llrs",
           "relocate_registry", "run_point", "schedules_from_registry",
           "settings"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REGISTRY = os.path.join(REPO, "docs", "artifacts",
                        "minsum_trained_schedules.json")
# the base of every point's frame seeds (the JAX campaign's key)
SEED = 20260821


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The campaign's configuration from its ``EF_*`` variables."""
    env = os.environ.get
    return dict(
        code=env("EF_CODE", "wifi1944"),
        snrs=tuple(float(x) for x in env("EF_SNRS", "2.5,3.0,3.5")
                   .split(",")),
        target_bits=float(env("EF_TARGET_BITS", "1e11")),
        only=tuple(s for s in env("EF_ONLY", "").split(",") if s),
        max_errs=float(env("EF_MAX_ERRS", "2e6")),
        batch=int(env("EF_BATCH", "32768")),
        chunk_steps=int(env("EF_CHUNK_STEPS", "32")),
        registry=env("EF_REGISTRY") or REGISTRY,
        device=env("EF_DEVICE", "cuda"),
        out=env("EF_OUT", ""),
        resume=env("EF_RESUME", ""),
        ctrl_from=env("EF_CTRL_FROM", ""),
    )


def point_llrs(code, snr_db: float, pidx: int, step: int, batch: int,
               dev) -> torch.Tensor:
    """The frames of step ``step`` at point ``pidx``: all-zero codewords,
    BPSK ``r = 1 + σ·n`` with ``σ = snr^-½``, LLR (log Pr1/Pr0) = −2r/σ²,
    drawn from ``stable_seed(SEED, pidx, step)`` on ``dev``."""
    return bpsk_llrs(code, snr_db, stable_seed(SEED, pidx, step), batch,
                     dev)


def schedules_from_registry(name: str, reg: dict, reg_dir: str, dev
                            ) -> list[tuple[str, dict]]:
    """The campaign's (name, ``bp_decode`` arguments) list for the library
    code ``name`` from the trained-schedule registry ``reg`` (keyed by
    library name; its ``.npz`` paths relative to ``reg_dir``); per-edge
    weights packed once on ``dev``."""
    code = get_code(name)
    schedules = [
        ("flooding-20", dict(iterations=20, schedule="flooding")),
        ("layered-10", dict(iterations=10, schedule="layered")),
    ]
    ent_code = reg.get(name, {})
    for kstr, ent in sorted(ent_code.get("layered", {}).items(),
                            key=lambda kv: int(kv[0])):
        al = tuple(float(x) for x in ent["alpha"])
        be = tuple(float(x) for x in ent["beta"])
        if ent.get("parity_ok"):
            schedules.append((
                f"trained-layered-{kstr}",
                dict(iterations=int(kstr), schedule="layered",
                     alpha=al, beta=be),
            ))
        # the probe composite: probe schedule K, then the full-budget
        # layered-20 pass over the syndrome stragglers
        schedules.append((
            f"probe-trained{kstr}-20",
            dict(iterations=20, schedule="layered", early_stop=True,
                 es_mode="probe", es_probe_iters=int(kstr),
                 es_probe_alpha=al, es_probe_beta=be, backend="cuda"),
        ))
    # the trained per-edge (+α/β) layered decoders, whatever their guard
    # parity, so the registry carries their floor data
    for kstr, ent in sorted(ent_code.get("edge_layered", {}).items(),
                            key=lambda kv: int(kv[0])):
        with np.load(os.path.join(reg_dir, ent["weights_npz"])) as z:
            wts = {k: z[k] for k in z.files if k.startswith("w_")}
        kw = dict(iterations=int(kstr), schedule="layered", backend="cuda",
                  weights=pack_decoder_weights(wts, code, int(kstr), dev))
        if ent.get("alpha"):
            kw["alpha"] = tuple(float(x) for x in ent["alpha"])
            kw["beta"] = tuple(float(x) for x in ent["beta"])
        schedules.append((f"edge-layered-{kstr}", kw))
    schedules.append((
        "probe-plain4-20",
        dict(iterations=20, schedule="layered", early_stop=True,
             es_mode="probe", es_probe_iters=4, backend="cuda"),
    ))
    return schedules


def relocate_registry(reg: dict, reg_dir: str, new_dir: str) -> dict:
    """``reg``, whose ``.npz`` paths are relative to ``reg_dir``, for a
    copy in ``new_dir``: each ``weights_npz`` rewritten relative to
    ``new_dir``, so :func:`schedules_from_registry` reads the copy as it
    reads ``reg``; a new dict."""
    reg = json.loads(json.dumps(reg))
    for node in reg.values():
        for ent in (node.get("edge_layered", {}).values()
                    if isinstance(node, dict) else ()):
            ent["weights_npz"] = os.path.relpath(
                os.path.join(os.path.abspath(reg_dir), ent["weights_npz"]),
                os.path.abspath(new_dir))
    return reg


def run_point(code, name: str, decode_kw: dict, snr_db: float, pidx: int,
              cfg: dict, dev) -> dict:
    """One (schedule, point): chunks of ``chunk_steps`` decodes, each
    chunk's bit and frame errors summed as int64 on ``dev`` and read once,
    until ``target_bits`` info bits or ``max_errs`` bit errors."""
    batch, steps = cfg["batch"], cfg["chunk_steps"]
    n_chunks = max(1, math.ceil(cfg["target_bits"]
                                / (batch * code.k * steps)))
    be_tot = fe_tot = frames = 0
    t0 = time.perf_counter()
    for c in range(n_chunks):
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        for i in range(steps):
            llr = point_llrs(code, snr_db, pidx, c * steps + i, batch, dev)
            bits = bp_decode(llr, code, method="min-sum", output="hard",
                             **decode_kw)
            errs = bits.sum(1, dtype=torch.int64)
            acc += torch.stack([errs.sum(), (errs > 0).sum()])
        be, fe = acc.tolist()  # the chunk's one host read
        be_tot += be
        fe_tot += fe
        frames += batch * steps
        if be_tot >= cfg["max_errs"]:
            break
    wall = time.perf_counter() - t0
    coded = frames * code.n
    res = {
        "schedule": name, "snr_db": snr_db,
        "info_bits": frames * code.k, "coded_bits": coded,
        "bit_errs": be_tot, "frame_errs": fe_tot, "frames": frames,
        "ber": be_tot / coded, "fler": fe_tot / frames,
        "wall_s": wall,
    }
    log(f"{name} @{snr_db} dB: BER {res['ber']:.3e} ({be_tot} errs / "
        f"{coded:.3g} coded bits), FLER {res['fler']:.3e} ({fe_tot} "
        f"frames), {wall:.1f}s")
    return res


def floor_verdicts(results: list[dict]) -> dict[str, list[dict]]:
    """Per schedule, its floor_ok at each point against the paired
    control: bit errors ≤ ce·1.15 + 5·√ce + 20, ce the control's errors
    scaled to the schedule's coded bits."""
    ctrl = {r["snr_db"]: r for r in results
            if r["schedule"] == "flooding-20"}
    verdicts: dict[str, list[dict]] = {}
    for r in results:
        if r["schedule"] == "flooding-20":
            continue
        c = ctrl.get(r["snr_db"])
        if c is None or c["coded_bits"] == 0:
            continue
        ce = c["bit_errs"] * r["coded_bits"] / c["coded_bits"]
        ok = r["bit_errs"] <= ce * 1.15 + 5.0 * math.sqrt(ce) + 20.0
        verdicts.setdefault(r["schedule"], []).append(
            {"snr_db": r["snr_db"], "floor_ok": bool(ok),
             "ber": r["ber"], "ber_ctrl": c["ber"]})
        log(f"verdict {r['schedule']} @{r['snr_db']} dB: {r['ber']:.3e} vs "
            f"control {c['ber']:.3e} -> {'OK' if ok else 'FLOORS'}")
    return verdicts


def fold_registry(reg: dict, code_name: str, verdicts: dict) -> dict:
    """``reg`` with the campaign's floor_ok flags folded in (the layered
    and per-edge layered entries, and ``layered_plain_floor_ok``), as a
    new dict: ``reg`` itself is left as it was."""
    reg = json.loads(json.dumps(reg))
    for fam, prefix in (("layered", "trained-layered-"),
                        ("edge_layered", "edge-layered-")):
        for kstr, ent in reg.get(code_name, {}).get(fam, {}).items():
            vs = verdicts.get(f"{prefix}{kstr}")
            if vs:
                ent["floor_ok"] = all(v["floor_ok"] for v in vs)
                ent["floor_points_db"] = [v["snr_db"] for v in vs]
    vs = verdicts.get("layered-10")
    if vs is not None:
        reg.setdefault(code_name, {})["layered_plain_floor_ok"] = all(
            v["floor_ok"] for v in vs)
    return reg


def main() -> int:
    cfg = settings()
    dev = resolve_device(cfg["device"])
    code = get_code(cfg["code"])
    log(f"device: {dev} "
        f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})"
        f", code: {cfg['code']}, batch={cfg['batch']}")
    reg = {}
    if os.path.exists(cfg["registry"]):
        with open(cfg["registry"]) as f:
            reg = json.load(f)
    schedules = schedules_from_registry(
        cfg["code"], reg, os.path.dirname(os.path.abspath(cfg["registry"])),
        dev)

    results: list[dict] = []
    done: set = set()
    if cfg["resume"] and os.path.exists(cfg["resume"]):
        with open(cfg["resume"]) as f:
            results = json.load(f)["points"]
        done = {(r["schedule"], r["snr_db"]) for r in results}
        out_path = cfg["resume"]
    else:
        tag = "" if cfg["code"] == "wifi1944" else f"_{cfg['code']}"
        out_path = cfg["out"] or os.path.join(
            "outputs", f"{time.strftime('%Y%m%d-%H%M%S')}_error_floor"
                       f"{tag}.json")
    # control points from an earlier record with the same frames (the
    # seeds depend only on (point, step), never on the schedule)
    if cfg["ctrl_from"]:
        with open(cfg["ctrl_from"]) as f:
            prev = json.load(f)
        if prev["batch"] != cfg["batch"]:
            raise ValueError("EF_CTRL_FROM needs the same EF_BATCH")
        for r in prev["points"]:
            if (r["schedule"] == "flooding-20"
                    and ("flooding-20", r["snr_db"]) not in done):
                results.append(r)
                done.add(("flooding-20", r["snr_db"]))
                log(f"imported control @{r['snr_db']} dB from "
                    f"{cfg['ctrl_from']}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    head = {"code": cfg["code"], "batch": cfg["batch"],
            "target_info_bits": cfg["target_bits"], "paired": True,
            "device": str(dev)}

    def write(extra=None):
        with open(out_path, "w") as f:
            json.dump({**head, "points": results, **(extra or {})}, f,
                      indent=1)

    for pidx, snr_db in enumerate(cfg["snrs"]):
        for name, decode_kw in schedules:
            if (cfg["only"] and name != "flooding-20"
                    and name not in cfg["only"]):
                continue
            if (name, snr_db) in done:
                log(f"skip {name} @{snr_db} dB (resumed)")
                continue
            results.append(run_point(code, name, decode_kw, snr_db, pidx,
                                     cfg, dev))
            write()

    verdicts = floor_verdicts(results)
    write({"verdicts": verdicts})
    log(f"record: {out_path}")
    if reg:
        folded = fold_registry(reg, cfg["code"], verdicts)
        reg_out = os.path.splitext(out_path)[0] + "_schedules.json"
        with open(reg_out, "w") as f:
            json.dump(folded, f, indent=1)
        log(f"registry with this run's floor_ok: {reg_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
