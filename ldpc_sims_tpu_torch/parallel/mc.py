"""Resumable Monte-Carlo BER/BLER sweep engine on one device.

The port of ``parallel/mc.py`` (``mc_step``, ``run_sweep``): each step
simulates a whole codeword block on the device, points stop adaptively on
a frame-error target, and every point's accumulated counts persist to a
JSON manifest so an interrupted sweep resumes where it stopped.

Seeds. A sweep derives every generator seed from ``SweepConfig.seed``:
point ``i`` has seed ``stable_seed(seed, i)``, and the chunk that starts
after ``steps`` accumulated steps of that point draws from one
``torch.Generator`` seeded with ``stable_seed(point_seed, steps)``; the
chunk's ``steps_per_sync`` link steps draw from it in turn.
``stable_seed`` hashes the parts with BLAKE2b, so the stream is the same
in every process and on every machine, and a resumed sweep continues the
stream an uninterrupted one would have drawn (for the same
``steps_per_sync``). PyTorch's generators differ from ``jax.random``: the
two packages agree statistically, not sample by sample.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable

import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.bp import pack_decoder_weights
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
from ldpc_sims_tpu_torch.utils.device import resolve_device
from ldpc_sims_tpu_torch.utils.metrics import PhaseTimer

__all__ = [
    "SweepConfig",
    "SweepResult",
    "mc_step",
    "run_sweep",
    "stable_seed",
]


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Adaptive-stopping sweep over an SNR grid.

    A point stops when ``target_frame_errors`` frames have failed or
    ``max_info_bits`` have been simulated — whichever first (and never
    before ``min_info_bits``). ``steps_per_sync`` MC steps run per host
    read of the counts; the stopping rule can overshoot by up to one
    chunk, and the chunk size is recorded in the manifest.
    """

    snrdb: tuple[float, ...] = tuple(float(s) for s in range(0, 11))
    batch_cw: int = 4096
    target_frame_errors: int = 100
    max_info_bits: float = 1e8
    min_info_bits: float = 1e5
    seed: int = 0
    steps_per_sync: int = 1


@dataclasses.dataclass
class SweepResult:
    snrdb: list[float]
    uncoded_ber: list[float]
    coded_ber: list[float]
    coded_bler: list[float]
    info_bits: list[float]
    frames: list[float]
    wall_s: list[float]

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_COUNT_KEYS = (
    "uncoded_bit_errors",
    "coded_bit_errors",
    "frame_errors",
    "uncoded_bits",
    "info_bits",
    "frames",
)


def stable_seed(*parts) -> int:
    """A 63-bit seed from a process-stable hash of ``parts``' reprs."""
    tag = "|".join(repr(p) for p in parts).encode()
    digest = hashlib.blake2b(tag, digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def mc_step(
    code: LdpcCode,
    cfg: LinkConfig,
    batch_cw: int,
    mesh=None,
    weights=None,
    steps_per_sync: int = 1,
    device="cuda",
) -> Callable:
    """Build the Monte-Carlo step: ``(seed, snrdb) → counts``.

    One call seeds a ``torch.Generator`` on ``device`` with ``seed`` and
    runs ``steps_per_sync`` link steps of ``batch_cw`` codewords from it,
    summing the counts on the device (0-d int32 tensors). ``weights``:
    decoder weights (JAX's dict), moved to ``device`` and packed into the
    kernels' tables here, once, not in every step.
    """
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet (ROADMAP A6: parallel/mesh.py "
            "to torch.distributed)"
        )
    dev = resolve_device(device)
    if steps_per_sync < 1:
        raise ValueError(f"steps_per_sync={steps_per_sync} must be >= 1")
    # int32 count accumulators: the largest per-chunk total is
    # uncoded_bits = steps x batch x n — guard the overflow bound
    if steps_per_sync * batch_cw * code.n >= 2**31 - 1:
        raise ValueError(
            "steps_per_sync x batch_cw x n overflows int32 counts; "
            "lower steps_per_sync or batch_cw"
        )

    weights = pack_decoder_weights(weights, code, cfg.bp_iterations, dev)

    def run(seed: int, snrdb: float) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        acc = None
        for _ in range(steps_per_sync):
            out = link_step(gen, snrdb, code, cfg, batch_cw, weights=weights)
            c = {k: out[k] for k in _COUNT_KEYS}
            acc = c if acc is None else {k: acc[k] + c[k] for k in c}
        return acc

    return run


def run_sweep(
    code: LdpcCode,
    link_cfg: LinkConfig,
    sweep: SweepConfig,
    mesh=None,
    weights=None,
    manifest_path: str | None = None,
    log: Callable[[str], None] | None = print,
    metrics: Any | None = None,
    save_every_s: float = 20.0,
    device="cuda",
) -> SweepResult:
    """Run (or resume) a BER/BLER sweep; returns per-point rates.

    ``manifest_path``: JSON file holding accumulated counts per SNR point
    — an interrupted sweep resumes from it (finished points are skipped).
    Manifest writes happen at most every ``save_every_s`` seconds and at
    point boundaries. ``metrics``: optional object with
    ``log(event, **fields)`` receiving one event per step, per finished
    point and per ``es_mode='auto'`` choice (``es-auto``, with each
    mode's calibration time in seconds). ``device``: where the steps run
    (``'cuda'`` by default). ``weights``: decoder weights for every
    decode (JAX's dict; each ``mc_step`` packs them once). With ``early_stop`` and ``es_mode='auto'``,
    each point times the fixed decode against ``es_mode='probe'`` on its
    first chunks and keeps the faster (``es_auto_mode`` in the manifest;
    a resumed point reuses it).
    """
    if link_cfg.es_mode == "auto" and link_cfg.early_stop:
        # the adaptive decode's dispatch: the probe decode beats the fixed
        # decode above an SNR-dependent crossover and loses below it, so
        # 'auto' times both on each point's first chunks (each mode warmed
        # once per sweep first) and keeps the faster, recorded per point
        # in the manifest as es_auto_mode. Every calibration chunk's
        # counts accumulate into the point, as in the JAX package (both
        # decoders give full-budget-grade BER: stragglers re-decode at the
        # full budget). The choice rests on this process's clocks.
        steps = {
            "fixed": mc_step(
                code, dataclasses.replace(link_cfg, early_stop=False,
                                          es_mode="freeze"),
                sweep.batch_cw, mesh, weights,
                steps_per_sync=sweep.steps_per_sync, device=device),
            "probe": mc_step(
                code, dataclasses.replace(link_cfg, es_mode="probe"),
                sweep.batch_cw, mesh, weights,
                steps_per_sync=sweep.steps_per_sync, device=device),
        }
    else:
        if link_cfg.es_mode == "auto":  # auto without early_stop
            link_cfg = dataclasses.replace(link_cfg, es_mode="freeze")
        # the one mode's name, as the step events report it
        only = link_cfg.es_mode if link_cfg.early_stop else "fixed"
        steps = {only: mc_step(code, link_cfg, sweep.batch_cw, mesh, weights,
                               steps_per_sync=sweep.steps_per_sync,
                               device=device)}
    warmed: set[str] = set()
    # the first step (its kernels loaded, and built on first use) vs the
    # steady state
    timer = PhaseTimer()

    state: dict[str, Any] = {"points": {}}
    if manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            state = json.load(f)
        prev = state.get("steps_per_sync")
        if prev is not None and prev != sweep.steps_per_sync and log:
            log(
                f"manifest was written with steps_per_sync={prev}, "
                f"resuming with {sweep.steps_per_sync}: results stay "
                "unbiased but the random stream is not reproducible "
                "across the boundary"
            )
    state["steps_per_sync"] = sweep.steps_per_sync

    def save():
        if manifest_path:
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, indent=1)
            os.replace(tmp, manifest_path)

    result = SweepResult([], [], [], [], [], [], [])
    last_save = time.perf_counter()

    for i, snrdb in enumerate(sweep.snrdb):
        pkey = f"{snrdb:g}"
        acc = state["points"].get(
            pkey, {k: 0.0 for k in _COUNT_KEYS} | {"steps": 0, "wall_s": 0.0}
        )
        point_seed = stable_seed(sweep.seed, i)
        chosen = acc.get("es_auto_mode") if len(steps) > 1 else next(
            iter(steps))
        timings: dict[str, float] = {}

        while not _point_done(acc, sweep):
            if chosen is not None:
                mode = chosen
            else:  # calibration: warm each mode once, then time each
                mode = next(m for m in steps if m not in timings)
            seed = stable_seed(point_seed, int(acc["steps"]))
            phase = ("compile+first-step" if not timer.counts
                     else "steady-step")
            t0 = time.perf_counter()
            with timer.phase(phase):
                out = steps[mode](seed, snrdb)
                # one host read of the chunk's counts
                vals = torch.stack([out[k] for k in _COUNT_KEYS]).tolist()
                counts = {k: float(v) for k, v in zip(_COUNT_KEYS, vals)}
            dt = time.perf_counter() - t0
            if chosen is None:
                if mode in warmed:
                    timings[mode] = dt
                    if len(timings) == len(steps):
                        chosen = min(timings, key=timings.get)
                        acc["es_auto_mode"] = chosen
                        if log:
                            t = ", ".join(f"{m}: {v * 1e3:.1f} ms"
                                          for m, v in timings.items())
                            log(f"es auto @{snrdb:g} dB: {t} -> {chosen}")
                        if metrics is not None:
                            metrics.log("es-auto", snrdb=float(snrdb),
                                        mode=chosen, **timings)
                else:
                    warmed.add(mode)
            acc["wall_s"] += dt
            for k in _COUNT_KEYS:
                acc[k] += counts[k]
            acc["steps"] += sweep.steps_per_sync
            state["points"][pkey] = acc
            if metrics is not None:
                metrics.log("sweep-step", snrdb=float(snrdb), wall_s=dt,
                            mode=mode, **counts)
            if time.perf_counter() - last_save >= save_every_s:
                save()
                last_save = time.perf_counter()

        save()  # point boundary: persist before moving on
        last_save = time.perf_counter()
        if metrics is not None:
            metrics.log("sweep-point", snrdb=float(snrdb), **acc)
        result.snrdb.append(float(snrdb))
        result.uncoded_ber.append(
            acc["uncoded_bit_errors"] / acc["uncoded_bits"])
        result.coded_ber.append(acc["coded_bit_errors"] / acc["info_bits"])
        result.coded_bler.append(acc["frame_errors"] / acc["frames"])
        result.info_bits.append(acc["info_bits"])
        result.frames.append(acc["frames"])
        result.wall_s.append(acc["wall_s"])
        if log:
            log(
                f"snr={snrdb:5.2f} dB  BER={result.coded_ber[-1]:.3e}  "
                f"BLER={result.coded_bler[-1]:.3e}  "
                f"({acc['info_bits']:.2e} info bits, {acc['wall_s']:.1f}s)"
            )
    phases = timer.summary()
    if metrics is not None and phases:
        metrics.log("sweep-phases", **phases)
    if log and phases:
        parts = ", ".join(
            f"{k}: {v['total_s']:.2f}s/{v['count']}" for k, v in
            phases.items()
        )
        log(f"phases: {parts}")
    return result


def _point_done(acc: dict[str, float], sweep: SweepConfig) -> bool:
    if acc["info_bits"] < sweep.min_info_bits:
        return False
    if acc["info_bits"] >= sweep.max_info_bits:
        return True
    return acc["frame_errors"] >= sweep.target_frame_errors
