"""Sharded, resumable Monte-Carlo BER/BLER sweep engine.

The port of ``parallel/mc.py`` (``mc_step``, ``run_sweep``, ``run_grid``,
``scaling_probe``): each step simulates a whole codeword block on the
device, points stop adaptively on a frame-error target, and every
point's accumulated counts persist to a JSON manifest so an interrupted
sweep resumes where it stopped. Over a :class:`~.mesh.Mesh` of processes
(one a GPU, ``torch.distributed``) each rank simulates its shard of the
block and one ``all_reduce`` a call sums the counts, so every rank sees
the same totals and takes the same stopping decisions. With
``mesh=None`` the world's mesh is used when a process group is
initialised, and this one process otherwise.

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

Shards. On a mesh of N ranks, shard i (its flat index over (snr, batch))
draws from a generator seeded with ``stable_seed(seed, "shard", i)``; on
a one-rank mesh it draws from ``seed`` itself, so a sweep on one rank of
a process group equals the sweep without one, bit for bit. The JAX
package gives shard i ``jax.random.split(key, N)[i]``, and a one-device
mesh ``split(key, 1)[0]``, which is not ``key``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.bp import pack_decoder_weights
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
from ldpc_sims_tpu_torch.parallel.mesh import local_batch_multiple, make_mesh
from ldpc_sims_tpu_torch.utils.device import resolve_device
from ldpc_sims_tpu_torch.utils.metrics import (
    STEP,
    SWEEP_READ,
    PhaseTimer,
    span,
)

__all__ = [
    "SweepConfig",
    "SweepResult",
    "mc_step",
    "run_sweep",
    "run_grid",
    "scaling_probe",
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


def shard_seed(seed: int, index: int, size: int) -> int:
    """The generator seed of shard ``index`` of ``size``: ``seed`` itself
    on one shard (the mesh-less stream), else ``stable_seed(seed,
    "shard", index)``."""
    return seed if size == 1 else stable_seed(seed, "shard", index)


def _stack_counts(out: dict) -> torch.Tensor:
    return torch.stack([out[k] for k in _COUNT_KEYS])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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

    One call seeds a ``torch.Generator`` on ``device`` and runs
    ``steps_per_sync`` link steps from it, summing the counts on the
    device (0-d int32 tensors). Over a ``mesh`` of N ranks each rank runs
    ``batch_cw / N`` codewords a link step from its shard's seed
    (:func:`shard_seed`) and the six counts are summed over the mesh with
    one ``all_reduce`` a call, so every rank returns the global counts.
    ``weights``: decoder weights (JAX's dict), moved to ``device`` and
    packed into the kernels' tables here, once, not in every step.
    While a profiler records, a call is the span ``ldpc.mc.step``
    (:data:`..utils.metrics.STEP`), whose host syncs are counted.
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = local_batch_multiple(mesh)
    if batch_cw % n_dev:
        raise ValueError(f"batch_cw={batch_cw} not divisible by {n_dev} devices")
    per_dev = batch_cw // n_dev
    shard = mesh.index
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
        with span(STEP, dev):
            gen = torch.Generator(device=dev)
            gen.manual_seed(shard_seed(seed, shard, n_dev))
            acc = None
            for _ in range(steps_per_sync):
                out = link_step(gen, snrdb, code, cfg, per_dev,
                                weights=weights)
                c = {k: out[k] for k in _COUNT_KEYS}
                acc = c if acc is None else {k: acc[k] + c[k] for k in c}
            if n_dev > 1:
                acc = dict(zip(_COUNT_KEYS, mesh.all_reduce_sum(
                    _stack_counts(acc)).unbind()))
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
    decode (JAX's dict; each ``mc_step`` packs them once). With
    ``early_stop`` and ``es_mode='auto'``, each point times the fixed
    decode against ``es_mode='probe'`` on its first chunks and keeps the
    faster (``es_auto_mode`` in the manifest; a resumed point reuses it).

    Over a ``mesh`` of several ranks every rank calls this together: the
    counts are the mesh's sums, so every rank takes the same stopping
    decisions; rank 0 of the mesh alone reads and writes the manifest
    (its state is broadcast) and prints to ``log``; the es-auto choice is
    timed on every rank and rank 0's is broadcast, so no rank decodes
    another mode. ``metrics`` receives the events on whichever rank
    passes one (the CLI passes it on rank 0).
    """
    if mesh is None:
        mesh = make_mesh()
    leader = mesh.is_leader
    if not leader:
        log = None
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
    if leader and manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            state = json.load(f)
    state = mesh.broadcast(state)
    if manifest_path:
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
        # rank 0 alone: the JAX package writes from every controller
        if manifest_path and leader:
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
                with span(SWEEP_READ):
                    vals = torch.stack([out[k]
                                        for k in _COUNT_KEYS]).tolist()
                counts = {k: float(v) for k, v in zip(_COUNT_KEYS, vals)}
            dt = time.perf_counter() - t0
            if chosen is None:
                if mode in warmed:
                    timings[mode] = dt
                    if len(timings) == len(steps):
                        # rank 0's clocks decide for the whole mesh
                        chosen = mesh.broadcast(min(timings,
                                                    key=timings.get))
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


def run_grid(
    code: LdpcCode,
    cfg: LinkConfig,
    snrdb_grid: tuple[float, ...],
    cw_per_point: int,
    mesh=None,
    weights=None,
    seed: int = 0,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Fixed-work sweep with the SNR grid over the mesh's ``snr`` axis.

    The grid's points are split in contiguous blocks over the ``snr``
    axis and each point's ``cw_per_point`` codewords over the ``batch``
    axis; one ``all_reduce`` sums the (points, counts) table over the
    mesh, so every rank returns the per-point count arrays. Point ``p``
    draws from ``stable_seed(seed, p)``, its batch shard ``b`` of
    ``b_dim`` from :func:`shard_seed` of that: the counts of ``mc_step``
    over a ``batch``-axis mesh of ``b_dim`` ranks called with the point's
    seed. Each point is its own ``link_step``, not one vectorised call
    (the JAX package vmaps the grid, so an ``es_mode='probe'`` decode
    there runs both branches of its overflow ``lax.cond``): the probe
    driver runs once a point and shard.
    """
    if mesh is None:
        mesh = make_mesh()
    s_dim, b_dim = mesh.shape["snr"], mesh.shape["batch"]
    S = len(snrdb_grid)
    if S % s_dim:
        raise ValueError(f"grid size {S} not divisible by snr axis {s_dim}")
    if cw_per_point % b_dim:
        raise ValueError(
            f"cw_per_point {cw_per_point} not divisible by batch axis "
            f"{b_dim}"
        )
    if cw_per_point * code.n >= 2**31 - 1:
        raise ValueError("cw_per_point x n overflows int32 counts")
    per_shard_cw = cw_per_point // b_dim
    dev = resolve_device(device)
    weights = pack_decoder_weights(weights, code, cfg.bp_iterations, dev)
    si, bi = mesh.coords
    per_row = S // s_dim
    table = torch.zeros((S, len(_COUNT_KEYS)), dtype=torch.int32,
                        device=dev)
    for p in range(si * per_row, (si + 1) * per_row):
        gen = torch.Generator(device=dev)
        gen.manual_seed(shard_seed(stable_seed(seed, p), bi, b_dim))
        out = link_step(gen, snrdb_grid[p], code, cfg, per_shard_cw,
                        weights=weights)
        table[p] = _stack_counts(out)
    host = mesh.all_reduce_sum(table).cpu().numpy()
    return {k: host[:, j] for j, k in enumerate(_COUNT_KEYS)}


def scaling_probe(
    code: LdpcCode,
    cfg: LinkConfig,
    per_dev_cw: int = 512,
    device_counts: tuple[int, ...] = (1, 2, 4, 8),
    steps: int = 3,
    snrdb: float = 3.0,
    seed: int = 0,
    device="cuda",
) -> dict[str, Any]:
    """Weak-scaling probe: decoded info bits/s on N ranks at a fixed
    per-rank batch, for each N in ``device_counts`` up to the world size.

    For each N the first N ranks form a mesh (a subgroup: every rank of
    the world calls this together) and run one warm-up step, then
    ``steps`` timed ones; the other ranks wait at a barrier.
    ``efficiency[N] = rate(N) / (N · rate(1))``; ``host_frac`` is the
    share of the timed loop's wall time spent outside the steps (seed
    bookkeeping, reading the counts), which is what would cap the
    scaling, the collective being one small ``all_reduce`` a step. A step
    is timed to the device's completion of its work. Every rank returns
    rank 0's rows.
    """
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    out: dict[str, Any] = {
        "devices": [], "bits_per_s": [], "efficiency": [],
        "host_frac": [], "per_dev_cw": per_dev_cw, "steps": steps,
    }
    base_rate = None
    for nd in device_counts:
        if nd > world:
            break
        mesh = make_mesh(ranks=range(nd))
        if mesh.member:
            step = mc_step(code, cfg, per_dev_cw * nd, mesh, device=device)
            # warm-up (kernels loaded, first launches), outside the window
            _stack_counts(step(seed, snrdb)).tolist()
            seeds = [stable_seed(seed, i) for i in range(steps)]
            t_total = time.perf_counter()
            t_step = 0.0
            frames = 0.0
            for s in seeds:
                t0 = time.perf_counter()
                counts = step(s, snrdb)
                _sync(dev)
                t_step += time.perf_counter() - t0
                frames += float(counts["frames"])
            t_total = time.perf_counter() - t_total
            assert frames == per_dev_cw * nd * steps  # counts must scale
            rate = per_dev_cw * nd * steps * code.k / t_step
            if base_rate is None:
                base_rate = rate
            out["devices"].append(nd)
            out["bits_per_s"].append(rate)
            out["efficiency"].append(rate / (base_rate * nd))
            out["host_frac"].append(max(0.0, (t_total - t_step) / t_total))
        if world > 1:
            dist.barrier()
    return make_mesh().broadcast(out)


def _point_done(acc: dict[str, float], sweep: SweepConfig) -> bool:
    if acc["info_bits"] < sweep.min_info_bits:
        return False
    if acc["info_bits"] >= sweep.max_info_bits:
        return True
    return acc["frame_errors"] >= sweep.target_frame_errors
