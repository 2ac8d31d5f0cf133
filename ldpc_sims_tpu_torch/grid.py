"""Model-family orchestration: per-SNR training chains and grid evaluation
(the port of ``grid.py``).

The reference's headline experiment family is a grid of models: one LLR
estimator per (snr × qbits × clipdb) cell, made by a two-stage chain
(per-SNR unquantized models, then one quantized model per cell
warm-started from the unquantized one at the same SNR) and evaluated into
(snr × qbits × clipdb) BER/WMSE arrays. Here, as in the JAX package, the
workflow is two resumable drivers keyed by a ``family`` id in the run
registry:

* :func:`train_grid` runs the chain; every trained cell is recorded in
  ``registry.jsonl``, and re-running it skips cells whose checkpoints
  exist;
* :func:`evaluate_grid` walks the registry for a family, evaluates every
  checkpoint at its own cell on fresh channel data and returns the grid
  arrays (Traditional, quantized-LLR and NN curves).

The checkpoints and registry records are the JAX package's (its
``params.msgpack`` layout, the same record fields and paths), so a family
either package trained is evaluated and resumed by the other.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.chain import LinkConfig
from ldpc_sims_tpu_torch.utils.device import resolve_device
from ldpc_sims_tpu_torch.utils.metrics import fold_seed

__all__ = ["train_grid", "evaluate_grid"]

GRID_KEYS = (
    "uncoded_ber", "coded_ber", "coded_bler",
    "coded_ber_qllr", "coded_bler_qllr", "wmse_qllr",
    "coded_ber_nn", "coded_bler_nn", "wmse_nn",
)


def _cell_exists(runs: list[dict], **match: Any) -> str | None:
    """Checkpoint path of a finished cell, or None (resume support)."""
    for r in runs:
        if all(r.get(k) == v for k, v in match.items()):
            ckpt = r.get("ckpt")
            if ckpt and os.path.isfile(
                os.path.join(ckpt, "params.msgpack")
            ):
                return ckpt
    return None


def train_grid(
    code: LdpcCode,
    snrdb_grid: tuple[float, ...],
    qbits_grid: tuple[int, ...],
    clipdb_grid: tuple[float, ...],
    train_cfg,
    *,
    train_cfg_quantized=None,
    ofdm_size: int = 32,
    num_codewords: int = 4096,
    out_dir: str = "outputs",
    family: str | None = None,
    seed: int = 0,
    log: Callable[[str], None] | None = print,
    device="cuda",
) -> dict[str, Any]:
    """Train the reference's per-SNR model family as one resumable run.

    Stage 1: one fixed-SNR LLR estimator per SNR point on clean channel
    data. Stage 2: per (qbits, clipdb, snr) cell, warm-start from the
    stage-1 model at the same SNR and train on quantized inputs against
    clean-LLR targets, with ``train_cfg_quantized`` when given. A cell's
    data comes from a generator seeded with ``fold_seed(seed,
    crc32(tag))``, its tag ``{stage}_snr={snr:g}_qbits={q}_clipdb={c:g}``.
    Data, training and checkpoints run on ``device``. Returns the family
    manifest (ids → checkpoint paths).
    """
    from ldpc_sims_tpu_torch.models import LLRestimator
    from ldpc_sims_tpu_torch.training import make_llr_dataset, train_llr
    from ldpc_sims_tpu_torch.utils.checkpoint import load_checkpoint
    from ldpc_sims_tpu_torch.utils.registry import find_runs, record_run

    train_cfg_quantized = train_cfg_quantized or train_cfg
    dev = resolve_device(device)
    family = family or time.strftime("%Y%m%d-%H%M%S")
    runs = find_runs("train-llr", out_dir, family=family)
    manifest: dict[str, Any] = {
        "family": family,
        "snrdb": list(snrdb_grid),
        "qbits": list(qbits_grid),
        "clipdb": list(clipdb_grid),
        "unquantized": {},
        "quantized": {},
    }

    def train_cell(stage, snrdb, qbits, clipdb, warm_ckpt=None):
        tag = f"{stage}_snr={snrdb:g}_qbits={qbits}_clipdb={clipdb:g}"
        done = _cell_exists(
            runs, family=family, stage=stage, snrdb=snrdb,
            qbits=qbits, clipdb=clipdb,
        )
        if done:
            if log:
                log(f"[train-grid] skip {tag} (exists: {done})")
            return done
        link = LinkConfig(
            ofdm_size=ofdm_size, bp_iterations=1,
            qbits=qbits if qbits else None,
            clip_ratio=10 ** (clipdb / 10.0),
        )
        # the JAX package folds the same crc32 of the tag into its key
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_seed(seed, zlib.crc32(tag.encode())
                                  & 0x7FFFFFFF))
        x, y = make_llr_dataset(gen, code, link, num_codewords, snrdb=snrdb)
        tcfg = train_cfg if stage == "unquantized" else train_cfg_quantized
        init = None
        if warm_ckpt:  # the checkpoint's flax variables {"params": ...}
            init = load_checkpoint(warm_ckpt)[0]["params"]
        ckpt = os.path.join(out_dir, "model", f"{family}_{tag}")
        if log:
            log(f"[train-grid] train {tag}")
        train_llr(
            LLRestimator(ofdm_size), x, y, tcfg, init_params=init,
            ckpt_dir=ckpt, log=None,
            manifest={
                "model": "LLRestimator", "code": code.name,
                "family": family, "stage": stage, "snrdb": snrdb,
                "qbits": qbits, "clipdb": clipdb,
                "warm_start": warm_ckpt,
            },
            device=dev,
        )
        record_run(
            "train-llr", out_dir, code=code.name, ckpt=ckpt,
            family=family, stage=stage, snrdb=snrdb, qbits=qbits,
            clipdb=clipdb, warm_start=warm_ckpt,
        )
        return ckpt

    # stage 1: the per-SNR unquantized family
    for s in snrdb_grid:
        manifest["unquantized"][f"{s:g}"] = train_cell(
            "unquantized", float(s), 0, 0.0
        )
    # stage 2: quantized cells, warm-started at the matching SNR
    for qb in qbits_grid:
        for cl in clipdb_grid:
            for s in snrdb_grid:
                ckpt = train_cell(
                    "quantized", float(s), int(qb), float(cl),
                    warm_ckpt=manifest["unquantized"][f"{s:g}"],
                )
                manifest["quantized"][f"{s:g}_{qb}_{cl:g}"] = ckpt
    return manifest


def evaluate_grid(
    code: LdpcCode,
    family: str,
    *,
    link_base: LinkConfig | None = None,
    ofdm_size: int = 32,
    num_codewords: int = 4096,
    out_dir: str = "outputs",
    stage: str = "quantized",
    seed: int = 0,
    log: Callable[[str], None] | None = print,
    device="cuda",
) -> dict[str, Any]:
    """Evaluate every checkpoint of a trained family at its own grid cell.

    Walks the ``registry.jsonl`` records carrying the ``family`` id (a
    ``ValueError`` when there are none) and evaluates each cell with
    :func:`..evaluate.evaluate_sweep` at its training SNR on ``device``,
    with ``link_base``'s decoder (the JAX CLI's defaults when None) and
    the cell's ADC. Returns the reference's grid arrays, each of shape
    (n_snr, n_qbits, n_clipdb) as nested lists, NaN for untrained cells.
    """
    from ldpc_sims_tpu_torch.convert import llr_state_dict_from_flax
    from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
    from ldpc_sims_tpu_torch.models import LLRestimator
    from ldpc_sims_tpu_torch.utils.checkpoint import load_checkpoint
    from ldpc_sims_tpu_torch.utils.registry import find_runs

    runs = find_runs("train-llr", out_dir, family=family, stage=stage)
    if not runs:
        raise ValueError(
            f"no {stage!r} train-llr runs with family={family!r} in "
            f"{out_dir}/registry.jsonl"
        )
    snr_axis = sorted({float(r["snrdb"]) for r in runs})
    qbits_axis = sorted({int(r["qbits"]) for r in runs})
    clip_axis = sorted({float(r["clipdb"]) for r in runs})
    shape = (len(snr_axis), len(qbits_axis), len(clip_axis))
    grids = {k: np.full(shape, np.nan) for k in GRID_KEYS}
    base = link_base or LinkConfig()

    for r in runs:
        s, qb, cl = float(r["snrdb"]), int(r["qbits"]), float(r["clipdb"])
        ckpt = r["ckpt"]
        if not os.path.isfile(os.path.join(ckpt, "params.msgpack")):
            if log:
                log(f"[evaluate-grid] missing checkpoint {ckpt}, skipping")
            continue
        model = LLRestimator(ofdm_size)
        model.load_state_dict(
            llr_state_dict_from_flax(load_checkpoint(ckpt)[0]["params"]))
        link = dataclasses.replace(
            base, ofdm_size=ofdm_size,
            qbits=qb if qb else None, clip_ratio=10 ** (cl / 10.0),
        )
        ec = EvalConfig(snrdb=(s,), num_codewords=num_codewords, seed=seed)
        curves = evaluate_sweep(code, link, ec, model=model, log=None,
                                device=device)
        idx = (snr_axis.index(s), qbits_axis.index(qb),
               clip_axis.index(cl))
        for k in grids:
            if k in curves:
                grids[k][idx] = curves[k][0]
        if log:
            log(
                f"[evaluate-grid] snr={s:g} qbits={qb} clipdb={cl:g}: "
                f"trad={grids['coded_ber'][idx]:.3e} "
                f"nn={grids['coded_ber_nn'][idx]:.3e}"
            )

    return {
        "family": family,
        "code": code.name,
        "snrdb": snr_axis,
        "qbits": qbits_axis,
        "clipdb": clip_axis,
        "num_codewords": num_codewords,
        **{k: v.tolist() for k, v in grids.items()},
    }
