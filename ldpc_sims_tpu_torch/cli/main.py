"""Command-line interface: the twelve subcommands of the JAX package's CLI
(``sweep``, ``evaluate``, ``scaling-probe``, ``train-llr``,
``train-joint``, ``train-grid``, ``train-minsum``, ``evaluate-grid``,
``noise-study``, ``evaluate-joint``, ``generate-data``, ``code-info``).

    python -m ldpc_sims_tpu_torch sweep --preset reference
    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --method min-sum \\
        --iters 20 --clamp 0 --snr 1.5,2.0 --batch 32768 --max-bits 1e9
    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --method min-sum \\
        --schedule layered --iters 8 --clamp 0 --batch 32768 \\
        --bp-alpha 0.86,0.86,... --bp-beta 0.12,0.14,...
    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --method min-sum \\
        --schedule layered --iters 20 --clamp 0 --batch 32768 \\
        --early-stop --es-mode auto --snr 2.5,3.5
    python -m ldpc_sims_tpu_torch sweep --preset wifi648-sweep
    python -m ldpc_sims_tpu_torch sweep --code wifi648 --method sum-product \\
        --iters 20 --clamp 0 --msg-qbits 4 --qbits 3 --clipdb 0 --agc global
    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --method min-sum \\
        --schedule layered --iters 6 --clamp 0 --batch 32768 \\
        --weights-ckpt docs/artifacts/edge_layered_1944_K6.npz
    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --method min-sum \\
        --schedule layered --iters 20 --clamp 0 --batch 32768 \\
        --layered-group 4
    python -m ldpc_sims_tpu_torch sweep --code qc1944_r23 --method min-sum \\
        --schedule layered --iters 20 --early-stop --batch 32768 \\
        --snr-unit eb --snr 1:4.5:8 --profile --plot
    python -m ldpc_sims_tpu_torch evaluate --code wifi1944 --method min-sum \\
        --iters 20 --clamp 0 --qbits 3 --snr 1.5,2.0 --batch 32768 \\
        --ckpt outputs/model/<dir>
    python -m ldpc_sims_tpu_torch scaling-probe --code wifi1944 \\
        --method min-sum --iters 20 --clamp 0 --per-dev-cw 32768
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m ldpc_sims_tpu_torch sweep --multihost --code wifi1944 ...
    python -m ldpc_sims_tpu_torch train-llr --qbits 3 --snr-low 0 \\
        --snr-high 10
    python -m ldpc_sims_tpu_torch train-joint --qbits 3 --iters 3 \\
        --snrdb 5 --optimizer adam --lr 2e-5 --batch 2048
    python -m ldpc_sims_tpu_torch train-minsum --code wifi1944 \\
        --schedule layered --iters 10 --clamp 0 --snr-low 1.25 \\
        --snr-high 2.5 --steps 120 --batch 256
    python -m ldpc_sims_tpu_torch generate-data --num-codewords 4096
    python -m ldpc_sims_tpu_torch train-grid --snr 0,3,6 --qbits-grid 3 \\
        --clipdb-grid 0 --family fam
    python -m ldpc_sims_tpu_torch evaluate-grid --family fam --batch 65536
    python -m ldpc_sims_tpu_torch noise-study --snr 0,5,10
    python -m ldpc_sims_tpu_torch evaluate-joint --qbits 3 --ckpt <dir>
    python -m ldpc_sims_tpu_torch code-info --code qc1944_r56 --de

The defaults are the JAX CLI's (``ldpc_sims_tpu/cli/main.py:656-672,
723-724``): the reference chain, ref6432 over QPSK/OFDM-32 with 3
iterations of ``sum-product-ref`` and clamp 20, 0-10 dB in 11 points,
batch 4096, on the card; non-QC codes decode on the gather backend.
``--device cpu`` runs the plain version. The ``PRESETS`` table is the JAX
package's and every preset runs: ``small-cpu``, ``wifi648-sweep``,
``quantized-minsum`` (one sweep, manifest and curves file per message
width, tagged ``_msgq{b}``), ``ofdm-qam16`` and ``reference``.
``--weights-ckpt`` and ``--schedule-ckpt`` read ``.npz`` files and
checkpoint directories (``utils.load_decoder_weights``) and apply to a
preset too, as in the JAX CLI. ``--snr-unit eb`` reads ``--snr`` as Eb/N0 (a preset ignores it, as
in the JAX CLI). Every sweep appends its events (``sweep-step``,
``sweep-point``, ``sweep-phases``, ``es-auto``) to ``metrics.jsonl`` and
one ``sweep`` record to ``registry.jsonl`` under ``--out``, as the JAX
CLI does; ``--profile`` writes a ``torch.profiler`` Chrome trace to
``{stamp}_trace{tag}/`` and ``--plot`` the BER/BLER figure to
``{stamp}_ber{tag}.png`` (it needs matplotlib, and stops before the sweep
without it). ``sweep --multihost`` joins the process group ``torchrun``
sets up (one rank a GPU, NCCL; Gloo on the CPU) and sweeps on the world's
mesh, rank 0 writing every file. ``evaluate`` draws the Traditional,
Quantized (``--qbits``) and, with ``--ckpt`` (a JAX-format checkpoint
directory whose manifest names the estimator), NN curves on the same
bits into ``{stamp}_eval.json`` with a registry record; ``scaling-probe``
writes ``{stamp}_scaling.json``. ``train-llr``, ``train-joint`` and
``train-minsum`` train on the device (the gradient decodes on the plain
version) and write their checkpoints in the JAX package's layout under
``--out/model/`` with a registry record (``train-minsum`` prints the
trained schedule as ``--bp-alpha``/``--bp-beta`` lines, and ``sweep
--schedule-ckpt`` reads its checkpoint); ``generate-data`` writes
``{stamp}_data.npz``. ``train-grid`` trains the per-SNR model family
(resumable by ``--family``) and ``evaluate-grid`` evaluates it into
``{stamp}_grid_{family}.json``, both in the JAX package's checkpoint and
registry formats; ``noise-study`` writes ``{stamp}_noise_study.json`` and
``evaluate-joint`` ``{stamp}_joint_eval.json``; ``code-info`` prints a
code's analysis (``--de``: its DE thresholds) as JSON. All twelve JAX
subcommands exist, each with JAX's flags and the port's ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

__all__ = ["PRESETS", "build_parser", "main", "sweep_configs"]

# The five benchmark configurations of the JAX package's CLI
# (ldpc_sims_tpu/cli/main.py PRESETS, BASELINE.json "configs").
PRESETS: dict[str, dict] = {
    # 1: small (128,64) regular LDPC, BPSK/AWGN, 10-iteration min-sum
    "small-cpu": dict(
        code="peg128_64",
        link=dict(modulation="bpsk", bp_iterations=10, bp_method="min-sum",
                  clamp=None, ofdm_size=32),
        sweep=dict(snrdb=(2.0,), batch_cw=1024, target_frame_errors=50,
                   max_info_bits=2e6),
    ),
    # 2: 802.11n (648,324), 0-6 dB, 20-iteration sum-product, layered
    #    with early stop and es_mode='auto'
    "wifi648-sweep": dict(
        code="wifi648",
        link=dict(modulation="qpsk", bp_iterations=20,
                  bp_method="sum-product", clamp=None, ofdm_size=32,
                  bp_schedule="layered", early_stop=True,
                  es_mode="auto"),
        sweep=dict(snrdb=tuple(np.linspace(0, 6, 13).tolist()),
                   batch_cw=4096, target_frame_errors=100,
                   steps_per_sync=8),
    ),
    # 3: the message-quantized min-sum decoder over a grid of bit widths
    "quantized-minsum": dict(
        code="wifi648",
        link=dict(modulation="qpsk", bp_iterations=20, bp_method="min-sum",
                  clamp=None, ofdm_size=32),
        sweep=dict(snrdb=tuple(np.linspace(0, 6, 7).tolist()),
                   batch_cw=4096, target_frame_errors=100,
                   steps_per_sync=8),
        msg_qbits_grid=(3, 4, 5),
    ),
    # 4: OFDM end to end, 64 subcarriers, 16-QAM, layered min-sum with
    #    early stop and es_mode='auto'
    "ofdm-qam16": dict(
        code="wifi1944",
        link=dict(modulation="qam16", bp_iterations=20,
                  bp_method="min-sum", clamp=None, ofdm_size=64,
                  bp_schedule="layered", early_stop=True,
                  es_mode="auto"),
        sweep=dict(snrdb=tuple(np.linspace(4, 12, 9).tolist()),
                   batch_cw=4096, target_frame_errors=100,
                   steps_per_sync=8),
    ),
    # 5: the reference chain (64,32) for BER parity studies
    "reference": dict(
        code="ref6432",
        link=dict(modulation="qpsk", bp_iterations=3,
                  bp_method="sum-product-ref", clamp=20.0, ofdm_size=32),
        sweep=dict(snrdb=tuple(float(s) for s in range(11)),
                   batch_cw=4096, target_frame_errors=100),
    ),
}


def _parse_snr(spec: str) -> tuple[float, ...]:
    """'0:10:11' → linspace(0, 10, 11); '1,2,3' → those points."""
    if ":" in spec:
        lo, hi, n = spec.split(":")
        return tuple(np.linspace(float(lo), float(hi), int(n)).tolist())
    return tuple(float(s) for s in spec.split(","))


def _snr_grid(args, code) -> tuple[float, ...]:
    """The --snr grid in symbol-SNR dB; '--snr-unit eb' converts it from
    Eb/N0 with the code's rate and the modulation's bits a symbol."""
    from ldpc_sims_tpu_torch.ops.chain import BITS_PER_SYMBOL

    grid = _parse_snr(args.snr)
    if args.snr_unit == "eb":
        off = 10.0 * float(np.log10(code.rate
                                    * BITS_PER_SYMBOL[args.modulation]))
        grid = tuple(s + off for s in grid)
    return grid


def _parse_ab(spec: str) -> float | tuple[float, ...]:
    """'0.8' → 0.8; '0.8,0.9,1.0' → per-iteration tuple."""
    parts = [x for x in str(spec).split(",") if x.strip() != ""]
    if not parts:
        raise argparse.ArgumentTypeError(
            f"empty alpha/beta spec {spec!r}; pass a float or a "
            "comma-separated per-iteration list"
        )
    try:
        vals = [float(x) for x in parts]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad alpha/beta spec {spec!r}; pass a float or a "
            "comma-separated per-iteration list like '0.8,0.9,1.0'"
        ) from None
    return vals[0] if len(vals) == 1 else tuple(vals)


def _decoder_weights_from_args(args):
    """--weights-ckpt: a trained decoder-weight npz."""
    if not args.weights_ckpt:
        return None
    from ldpc_sims_tpu_torch.utils import load_decoder_weights

    return load_decoder_weights(args.weights_ckpt)


def _apply_schedule_ckpt(args, link):
    """--schedule-ckpt: freeze a trained (ms_alpha, ms_beta) checkpoint
    into the link's static per-iteration alpha/beta tuples."""
    path = args.schedule_ckpt
    if not path:
        return link
    from ldpc_sims_tpu_torch.utils import load_decoder_weights

    ms = load_decoder_weights(path)
    if not {"ms_alpha", "ms_beta"} <= set(ms):
        raise SystemExit(
            f"--schedule-ckpt {path} holds {sorted(ms)}; expected a "
            "train-minsum checkpoint with ms_alpha/ms_beta (per-edge "
            "weight pytrees go to --weights-ckpt)"
        )
    from ldpc_sims_tpu_torch.ops.bp import freeze_minsum_weights

    alpha, beta = freeze_minsum_weights(ms)
    return dataclasses.replace(link, alpha=alpha, beta=beta)


def _link_cfg_from_args(args, **over):
    """The link flags every subcommand shares (``_add_common``), with
    ``over`` replacing fields (the JAX CLI's overrides)."""
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig

    fields = dict(
        modulation=args.modulation,
        ofdm_size=args.ofdm_size,
        bp_iterations=args.iters,
        bp_method=args.method,
        bp_schedule=args.schedule,
        alpha=args.bp_alpha,
        beta=args.bp_beta,
        clamp=args.clamp if args.clamp > 0 else None,
        qbits=args.qbits if args.qbits > 0 else None,
        clip_ratio=10 ** (args.clipdb / 10.0),
        agc=args.agc,
        early_stop=args.early_stop,
        es_mode=args.es_mode,
        es_check_every=args.es_check_every,
        es_probe_iters=args.es_probe_iters,
        es_probe_alpha=(_parse_ab(args.es_probe_alpha)
                        if args.es_probe_alpha else None),
        es_probe_beta=(_parse_ab(args.es_probe_beta)
                       if args.es_probe_beta else None),
        bp_layered_group=args.layered_group,
    )
    fields.update(over)
    return LinkConfig(**fields)


def sweep_configs(args):
    """What ``sweep`` runs for parsed ``args``: (code, LinkConfig,
    SweepConfig, the msg_qbits grid, the decoder weights or None)."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig
    from ldpc_sims_tpu_torch.parallel import SweepConfig

    if args.preset:
        p = PRESETS[args.preset]
        code = get_code(p["code"])
        link = LinkConfig(**p["link"])
        sweep = SweepConfig(**p["sweep"], seed=args.seed)
        grids = p.get("msg_qbits_grid", (None,))
    else:
        code = get_code(args.code)
        link = _link_cfg_from_args(args)
        sweep = SweepConfig(
            snrdb=_snr_grid(args, code), batch_cw=args.batch,
            target_frame_errors=args.target_errors,
            max_info_bits=args.max_bits, steps_per_sync=args.steps_per_sync,
            seed=args.seed,
        )
        grids = (args.msg_qbits if args.msg_qbits > 0 else None,)
    link = _apply_schedule_ckpt(args, link)
    return code, link, sweep, grids, _decoder_weights_from_args(args)


def _need_matplotlib(args) -> None:
    """--plot: stop now, not after a long run, when matplotlib is absent."""
    if getattr(args, "plot", False):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit(
                "--plot needs matplotlib, which is not installed here; "
                "run without --plot (the curves file holds the numbers)"
            ) from None


def cmd_sweep(args) -> None:
    from ldpc_sims_tpu_torch.parallel import (
        make_mesh,
        maybe_distributed_init,
        run_sweep,
    )
    from ldpc_sims_tpu_torch.utils import (
        MetricsLogger,
        profile_trace,
        record_run,
    )

    _need_matplotlib(args)
    distributed = False
    if args.multihost:
        # one process a GPU, launched by torchrun (python -m
        # torch.distributed.run), which sets WORLD_SIZE, RANK, MASTER_ADDR
        distributed = maybe_distributed_init()
        if distributed:
            import torch.distributed as dist

            print(f"distributed: backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, rank {dist.get_rank()}",
                  flush=True)
        else:
            print("--multihost: no torchrun environment (WORLD_SIZE, RANK, "
                  "MASTER_ADDR); sweeping on this process alone", flush=True)
    # rank 0 writes the files; every rank sweeps its shard
    leader = make_mesh().is_leader
    code, link, sweep, grids, weights = sweep_configs(args)
    metrics = (MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
               if leader else None)
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    for qb in grids:
        link_q = dataclasses.replace(link, msg_qbits=qb)
        tag = f"_msgq{qb}" if qb else ""
        if args.manifest:
            # one manifest per width: a shared one would resume each width
            # from the counts of the one before
            root, ext = os.path.splitext(args.manifest)
            manifest = root + (tag if len(grids) > 1 else "") + ext
        else:
            manifest = os.path.join(args.out, f"{stamp}_sweep{tag}.json")
        trace_dir = (os.path.join(args.out, f"{stamp}_trace{tag}")
                     if args.profile and leader else None)
        with profile_trace(trace_dir):
            result = run_sweep(code, link_q, sweep, weights=weights,
                               manifest_path=manifest, metrics=metrics,
                               device=args.device)
        if not leader:
            continue
        if trace_dir:
            print(f"profiler trace -> {trace_dir}")
        out = {
            "code": code.name,
            "preset": args.preset,
            "link": dataclasses.asdict(link_q),
            **result.as_dict(),
        }
        path = os.path.join(args.out, f"{stamp}_curves{tag}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        record_run("sweep", args.out, code=code.name, curves=path,
                   manifest=manifest, msg_qbits=qb)
        print(f"curves -> {path}")
        if args.plot:
            from ldpc_sims_tpu_torch.plotting import plot_ber_curves

            fig = plot_ber_curves(
                {"snrdb": result.snrdb, "coded_ber": result.coded_ber,
                 "coded_bler": result.coded_bler,
                 "uncoded_ber": result.uncoded_ber},
                os.path.join(args.out, f"{stamp}_ber{tag}.png"),
                title=f"{code.name}{tag}",
            )
            print(f"figure -> {fig}")
    if distributed:
        import torch.distributed as dist

        dist.destroy_process_group()


def load_llr_model(ckpt: str, ofdm_size: int):
    """The estimator of a JAX-format checkpoint directory (its manifest's
    ``model``, default ``LLRestimator``) with the checkpoint's weights:
    (module, with_snr_feature, tanh_model)."""
    from ldpc_sims_tpu_torch import models
    from ldpc_sims_tpu_torch.convert import llr_state_dict_from_flax
    from ldpc_sims_tpu_torch.utils import load_checkpoint

    tree, mani = load_checkpoint(ckpt)
    name = mani.get("model", "LLRestimator")
    estimators = ("LLRestimator", "LLRestimatorWithSNR", "LLRestimatorTanh")
    if name not in estimators:
        raise SystemExit(f"{ckpt}: unknown model {name!r}; expected one of "
                         f"{list(estimators)}")
    model = getattr(models, name)(ofdm_size)
    model.load_state_dict(llr_state_dict_from_flax(tree["params"]))
    return model, name != "LLRestimator", name == "LLRestimatorTanh"


def cmd_evaluate(args) -> None:
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.evaluate import EvalConfig, evaluate_sweep
    from ldpc_sims_tpu_torch.utils.registry import find_runs, record_run

    _need_matplotlib(args)
    code = get_code(args.code)
    link = _link_cfg_from_args(args)
    model = None
    snr_feature = tanh = False
    if args.ckpt:
        model, snr_feature, tanh = load_llr_model(args.ckpt, args.ofdm_size)
    ec = EvalConfig(
        snrdb=_snr_grid(args, code), num_codewords=args.batch,
        with_snr_feature=snr_feature, tanh_model=tanh, seed=args.seed,
    )
    link = _apply_schedule_ckpt(args, link)
    curves = evaluate_sweep(code, link, ec, model=model,
                            weights=_decoder_weights_from_args(args),
                            device=args.device)
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(args.out, f"{stamp}_eval.json")
    with open(path, "w") as f:
        json.dump({"code": code.name, **curves}, f, indent=1)
    parents = find_runs(out_dir=args.out, ckpt=args.ckpt) if args.ckpt else []
    record_run("evaluate", args.out, code=code.name, curves=path,
               ckpt=args.ckpt or None,
               parent=parents[-1]["id"] if parents else None)
    print(f"curves -> {path}")
    if args.plot:
        from ldpc_sims_tpu_torch.plotting import plot_ber_curves, plot_wmse

        print("figure ->",
              plot_ber_curves(curves,
                              os.path.join(args.out, f"{stamp}_ber.png")))
        if "wmse_nn" in curves or "wmse_qllr" in curves:
            print("figure ->",
                  plot_wmse(curves,
                            os.path.join(args.out, f"{stamp}_wmse.png")))


def cmd_scaling_probe(args) -> None:
    """Weak-scaling throughput/efficiency probe over the world's ranks
    (one process, or those torchrun launched)."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.parallel import (
        make_mesh,
        maybe_distributed_init,
        scaling_probe,
    )

    distributed = maybe_distributed_init()
    code = get_code(args.code)
    link = _link_cfg_from_args(args)
    counts = tuple(int(c) for c in args.devices.split(","))
    probe = scaling_probe(
        code, link, per_dev_cw=args.per_dev_cw, device_counts=counts,
        steps=args.steps, snrdb=args.snrdb, seed=args.seed,
        device=args.device,
    )
    if make_mesh().is_leader:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(
            args.out, f"{time.strftime('%Y%m%d-%H%M%S')}_scaling.json"
        )
        with open(path, "w") as f:
            json.dump(probe, f, indent=1)
        for i, nd in enumerate(probe["devices"]):
            print(
                f"devices={nd}: {probe['bits_per_s'][i]:.3e} bits/s, "
                f"efficiency={probe['efficiency'][i]:.2f}, "
                f"host overhead={probe['host_frac'][i] * 100:.1f}%"
            )
        print(f"probe -> {path}")
    if distributed:
        import torch.distributed as dist

        dist.destroy_process_group()


def _generator(args):
    """The dataset's generator: ``--seed`` on ``--device``."""
    import torch

    from ldpc_sims_tpu_torch.utils import resolve_device

    return torch.Generator(device=resolve_device(args.device)).manual_seed(
        args.seed)


def cmd_train_llr(args) -> None:
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.models import (
        LLRestimator,
        LLRestimatorTanh,
        LLRestimatorWithSNR,
    )
    from ldpc_sims_tpu_torch.training import (
        TrainConfig,
        make_llr_dataset,
        train_llr,
    )
    from ldpc_sims_tpu_torch.utils import load_checkpoint, record_run

    code = get_code(args.code)
    snr_cond = args.snr_high > args.snr_low
    link = _link_cfg_from_args(
        args, bp_iterations=1, snr_per_symbol=snr_cond,
        snrdb_low=args.snr_low, snrdb_high=args.snr_high,
    )
    x, y = make_llr_dataset(
        _generator(args), code, link, args.num_codewords,
        snrdb=args.snrdb, with_snr_feature=snr_cond, tanh_targets=args.tanh,
    )
    if args.tanh:
        model = LLRestimatorTanh(args.ofdm_size)
    elif snr_cond:
        model = LLRestimatorWithSNR(args.ofdm_size)
    else:
        model = LLRestimator(args.ofdm_size)
    tc = TrainConfig(
        learning_rate=args.lr, num_epochs=args.epochs,
        batch_size=args.batch, seed=args.seed, optimizer=args.optimizer,
    )
    init = None
    if args.warm_start:  # a checkpoint's flax variables {"params": ...}
        init = load_checkpoint(args.warm_start)[0]["params"]
    stamp = time.strftime("%Y%m%d-%H%M%S")
    ckpt = os.path.join(
        args.out, "model",
        f"{stamp}_llr_qbits={args.qbits}_clipdb={args.clipdb}"
        f"_snr={args.snr_low}-{args.snr_high}_lr={args.lr}",
    )
    train_llr(
        model, x, y, tc, init_params=init, ckpt_dir=ckpt,
        manifest={
            "model": type(model).__name__, "code": code.name,
            "qbits": args.qbits, "clipdb": args.clipdb,
            "snrdb": args.snrdb, "snr_low": args.snr_low,
            "snr_high": args.snr_high, "tanh": args.tanh,
        },
        device=args.device,
    )
    record_run("train-llr", args.out, code=code.name, ckpt=ckpt,
               qbits=args.qbits, clipdb=args.clipdb, snrdb=args.snrdb,
               snr_low=args.snr_low, snr_high=args.snr_high,
               warm_start=args.warm_start or None)
    print(f"checkpoint -> {ckpt}")


def cmd_train_joint(args) -> None:
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.models import Joint
    from ldpc_sims_tpu_torch.training import (
        TrainConfig,
        make_joint_dataset,
        train_joint,
    )
    from ldpc_sims_tpu_torch.utils import record_run

    code = get_code(args.code)
    link = _link_cfg_from_args(args, bp_iterations=1)
    x, bits = make_joint_dataset(_generator(args), code, link,
                                 args.num_codewords, snrdb=args.snrdb)
    model = Joint(code_name=args.code, ofdm_size=args.ofdm_size,
                  iterations=args.iters, clamp=args.clamp)
    tc = TrainConfig(learning_rate=args.lr, num_epochs=args.epochs,
                     batch_size=args.batch, seed=args.seed,
                     optimizer=args.optimizer)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    ckpt = os.path.join(args.out, "model", f"{stamp}_joint_snr={args.snrdb}")
    train_joint(model, x, bits, tc, ckpt_dir=ckpt,
                manifest={"model": "Joint", "code": code.name,
                          "snrdb": args.snrdb},
                device=args.device)
    record_run("train-joint", args.out, code=code.name, ckpt=ckpt,
               snrdb=args.snrdb)
    print(f"checkpoint -> {ckpt}")


def cmd_train_minsum(args) -> None:
    """Train per-iteration (α, β) min-sum weights; print the frozen
    schedule as ``--bp-alpha``/``--bp-beta`` comma lists."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.training import (
        TrainConfig,
        train_minsum_weights,
    )
    from ldpc_sims_tpu_torch.utils import record_run

    code = get_code(args.code)
    tc = TrainConfig(learning_rate=args.lr, seed=args.seed,
                     optimizer=args.optimizer)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    ckpt = os.path.join(
        args.out, "model",
        f"{stamp}_minsum_{args.code}_it={args.iters}_{args.schedule}",
    )
    _, info = train_minsum_weights(
        code, tc, iterations=args.iters, schedule=args.schedule,
        snr_db=(args.snr_low, args.snr_high), steps=args.steps,
        batch=args.batch, clamp=args.clamp if args.clamp > 0 else None,
        ckpt_dir=ckpt, device=args.device,
    )
    record_run("train-minsum", args.out, code=code.name, ckpt=ckpt,
               alpha=info["alpha"], beta=info["beta"])
    alpha = ",".join(f"{x:.4f}" for x in info["alpha"])
    beta = ",".join(f"{x:.4f}" for x in info["beta"])
    print(f"checkpoint -> {ckpt}")
    print(f"--bp-alpha {alpha}")
    print(f"--bp-beta {beta}")


def cmd_generate_data(args) -> None:
    """The LLR dataset to ``{stamp}_data.npz`` under ``--out``."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.training import make_llr_dataset

    code = get_code(args.code)
    link = _link_cfg_from_args(args, bp_iterations=1)
    x, y = make_llr_dataset(_generator(args), code, link,
                            args.num_codewords, snrdb=args.snrdb)
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(args.out, f"{stamp}_data.npz")
    np.savez_compressed(path, input_samples=x, output_samples=y)
    print(f"dataset -> {path}  x{x.shape} y{y.shape}")


def cmd_train_grid(args) -> None:
    """The per-SNR model-family chain (unquantized → quantized warm
    starts), resumable by --family; its manifest to
    ``{family}_family.json``."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.grid import train_grid
    from ldpc_sims_tpu_torch.training import TrainConfig

    code = get_code(args.code)
    tc = TrainConfig(
        learning_rate=args.lr, num_epochs=args.epochs,
        batch_size=args.batch, seed=args.seed,
        eval_every=args.eval_every, optimizer=args.optimizer,
    )
    tcq = dataclasses.replace(
        tc, learning_rate=args.quant_lr if args.quant_lr > 0 else args.lr
    )
    manifest = train_grid(
        code,
        train_cfg_quantized=tcq,
        snrdb_grid=_parse_snr(args.snr),
        qbits_grid=tuple(int(q) for q in args.qbits_grid.split(",") if q),
        clipdb_grid=tuple(
            float(c) for c in args.clipdb_grid.split(",") if c
        ),
        train_cfg=tc,
        ofdm_size=args.ofdm_size,
        num_codewords=args.num_codewords,
        out_dir=args.out,
        family=args.family or None,
        seed=args.seed,
        device=args.device,
    )
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{manifest['family']}_family.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"family '{manifest['family']}' manifest -> {path}")


def cmd_evaluate_grid(args) -> None:
    """Every checkpoint of a trained family at its own (snr, qbits,
    clipdb) cell, to ``{stamp}_grid_{family}.json`` with a registry
    record."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.grid import evaluate_grid
    from ldpc_sims_tpu_torch.utils.registry import record_run

    _need_matplotlib(args)
    code = get_code(args.code)
    link = _link_cfg_from_args(args, qbits=None)
    grid = evaluate_grid(
        code, args.family, link_base=link, ofdm_size=args.ofdm_size,
        num_codewords=args.batch, out_dir=args.out, stage=args.stage,
        seed=args.seed, device=args.device,
    )
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(args.out, f"{stamp}_grid_{args.family}.json")
    with open(path, "w") as f:
        json.dump(grid, f, indent=1)
    record_run("evaluate-grid", args.out, code=code.name,
               family=args.family, curves=path)
    print(f"grid -> {path}")
    if args.plot:
        from ldpc_sims_tpu_torch.plotting import plot_grid

        fig = plot_grid(
            grid, os.path.join(args.out, f"{stamp}_grid_{args.family}.png"),
            title=f"{code.name} family {args.family}",
        )
        print(f"figure -> {fig}")


def cmd_code_info(args) -> None:
    """Analyze a registry code or an imported QC shift table / alist:
    degrees, the QC cycle spectrum (girth evidence) and, with --de, the DE
    thresholds (on --device); the report as JSON on stdout."""
    from ldpc_sims_tpu_torch.codes.analyze import code_report

    if args.base_file:
        from ldpc_sims_tpu_torch.codes.qc_construct import load_qc_base

        code = load_qc_base(args.base_file)
    elif args.alist:
        from ldpc_sims_tpu_torch.codes import load_alist

        code = load_alist(args.alist)
    else:
        from ldpc_sims_tpu_torch.codes import get_code

        code = get_code(args.code)
    rep = code_report(code, de=args.de, device=args.device)
    print(json.dumps(rep, indent=1))


def cmd_noise_study(args) -> None:
    """The quantization-noise statistics grid to
    ``{stamp}_noise_study.json``. As in the JAX CLI, the study runs its
    own per-symbol AGC and clean clip: --agc, --clipdb, --modulation,
    --iters and the decoder flags do not reach it."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.diagnostics import quantization_noise_study

    code = get_code(args.code)
    records = quantization_noise_study(
        args.seed,
        code,
        snrdb_grid=_parse_snr(args.snr),
        qbits_grid=tuple(int(q) for q in args.qbits_grid.split(",")),
        clip_ratio_grid=tuple(
            10 ** (float(c) / 10.0) for c in args.clipdb_grid.split(",")
        ),
        num_codewords=args.batch,
        ofdm_size=args.ofdm_size,
        device=args.device,
    )
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(args.out, f"{stamp}_noise_study.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    for r in records:
        print(
            f"snr={r['snrdb']:5.1f} qbits={r['qbits']} "
            f"clip={r['clip_ratio']:.2f}: std={r['std']:.4f} "
            f"max|e|={r['max_abs']:.4f}"
        )
    print(f"records -> {path}")


def cmd_evaluate_joint(args) -> None:
    """A trained joint model against classic BP on the analytic and on
    the quantized LLRs, on the same bits, to ``{stamp}_joint_eval.json``.
    The classic decodes are sum-product whatever --method says, as in the
    JAX CLI."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.diagnostics import evaluate_joint
    from ldpc_sims_tpu_torch.models import Joint
    from ldpc_sims_tpu_torch.utils import load_checkpoint

    code = get_code(args.code)
    link = _link_cfg_from_args(args)
    model = Joint(code_name=args.code, ofdm_size=args.ofdm_size,
                  iterations=args.iters, clamp=args.clamp)
    tree, _ = load_checkpoint(args.ckpt)
    curves = evaluate_joint(
        model, tree["params"], code, link,
        snrdb_grid=_parse_snr(args.snr), num_codewords=args.batch,
        seed=args.seed, device=args.device,
    )
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(args.out, f"{stamp}_joint_eval.json")
    with open(path, "w") as f:
        json.dump({"code": code.name, **curves}, f, indent=1)
    print(f"curves -> {path}")


def _add_device(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain version")


def _add_common(sp: argparse.ArgumentParser) -> None:
    """The JAX CLI's shared flags (code, link, decoder, checkpoints, seed,
    output) and the port's --device."""
    sp.add_argument("--code", default="ref6432")
    sp.add_argument("--modulation", default="qpsk",
                    choices=["bpsk", "qpsk", "qam16"])
    sp.add_argument("--ofdm-size", type=int, default=32)
    sp.add_argument("--iters", type=int, default=3)
    sp.add_argument("--method", default="sum-product-ref",
                    choices=["min-sum", "sum-product", "sum-product-ref"],
                    help="check rule (sum-product-ref: the reference's "
                         "tanh-product rule)")
    sp.add_argument("--bp-alpha", default="1.0", type=_parse_ab,
                    help="min-sum normalization: a float or a "
                         "comma-separated per-iteration list")
    sp.add_argument("--bp-beta", default="0.0", type=_parse_ab,
                    help="min-sum offset: a float or a per-iteration list")
    sp.add_argument("--schedule", default="flooding",
                    choices=["flooding", "layered"],
                    help="layered = serial-C scheduling (QC codes only)")
    sp.add_argument("--clamp", type=float, default=20.0,
                    help="c2v message clamp (<=0 disables clamping)")
    sp.add_argument("--qbits", type=int, default=0,
                    help="ADC quantizer bits (0 = ideal ADC)")
    sp.add_argument("--clipdb", type=float, default=0.0,
                    help="ADC clip level over the AGC's, in dB "
                         "(clip_ratio = 10^(clipdb/10))")
    sp.add_argument("--agc", default="global",
                    choices=["global", "per-symbol"],
                    help="ADC gain control: the stream's std or the "
                         "per-OFDM-symbol analytic one")
    sp.add_argument("--early-stop", action="store_true",
                    help="per-codeword syndrome termination")
    sp.add_argument("--es-mode", default="freeze",
                    choices=["freeze", "requeue", "probe", "auto"],
                    help="early-stop strategy (requeue: early-stop probe, "
                         "then a full-budget pass over the stragglers; "
                         "probe: fixed probe with a fused syndrome count, "
                         "then a fixed full-budget pass over the "
                         "stragglers; auto: the sweep times fixed against "
                         "probe per SNR point and keeps the faster)")
    sp.add_argument("--es-probe-iters", type=int, default=4,
                    help="probe budget for --es-mode requeue/probe/auto")
    sp.add_argument("--es-probe-alpha", default="", type=str,
                    help="probe-pass alpha schedule for --es-mode probe "
                         "(comma list; empty = --bp-alpha)")
    sp.add_argument("--es-probe-beta", default="", type=str,
                    help="probe-pass beta schedule (see --es-probe-alpha)")
    sp.add_argument("--es-check-every", type=int, default=1,
                    help="syndrome-check stride under --early-stop (must "
                         "divide --iters)")
    sp.add_argument("--layered-group", type=int, default=1,
                    help="rows per serial group of the layered schedule "
                         "(1 = serial-C; cuda only)")
    sp.add_argument("--snr-unit", default="es", choices=["es", "eb"],
                    help="interpret --snr as symbol SNR (es) or Eb/N0 (eb)")
    sp.add_argument("--weights-ckpt", default="",
                    help="trained decoder-weight pytree (.npz or a "
                         "train-minsum/train_neural_bp checkpoint dir); "
                         "every decode uses exactly these weights")
    sp.add_argument("--schedule-ckpt", default="",
                    help="train-minsum checkpoint (.npz or dir) whose "
                         "(ms_alpha, ms_beta) freeze into static "
                         "per-iteration --bp-alpha/--bp-beta")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", default="outputs")
    _add_device(sp)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ldpc_sims_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="Monte-Carlo BER/BLER sweep")
    _add_common(sp)
    sp.add_argument("--preset", choices=sorted(PRESETS),
                    help="a whole configuration of the JAX package's "
                         "table (the code, link and sweep flags are then "
                         "ignored)")
    sp.add_argument("--snr", default="0:10:11",
                    help="SNR grid in dB: 'lo:hi:n' or 'a,b,c'")
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--target-errors", type=int, default=100)
    sp.add_argument("--max-bits", type=float, default=1e8)
    sp.add_argument("--steps-per-sync", type=int, default=1,
                    help="MC steps per host read of the counts")
    sp.add_argument("--msg-qbits", type=int, default=0,
                    help="quantize each c2v message to 2^b - 1 levels over "
                         "+-20 (0 = none)")
    sp.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun set up (one "
                         "rank a GPU, NCCL) and sweep on the world's mesh")
    sp.add_argument("--manifest", default="",
                    help="resume/accumulate manifest (default: new file "
                         "in --out)")
    sp.add_argument("--plot", action="store_true",
                    help="write the BER/BLER figure under --out (needs "
                         "matplotlib)")
    sp.add_argument("--profile", action="store_true",
                    help="wrap the sweep in a torch.profiler trace "
                         "(written under --out)")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("evaluate", help="evaluate curves (opt. with NN)")
    _add_common(sp)
    sp.add_argument("--ckpt", default="",
                    help="LLR-estimator checkpoint directory (the JAX "
                         "package's format; its manifest names the model)")
    sp.add_argument("--snr", default="0:10:11")
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--plot", action="store_true",
                    help="write the BER/BLER and WMSE figures under --out "
                         "(needs matplotlib)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("scaling-probe",
                        help="weak-scaling throughput/efficiency probe")
    _add_common(sp)
    sp.add_argument("--devices", default="1,2,4,8")
    sp.add_argument("--per-dev-cw", type=int, default=512)
    sp.add_argument("--steps", type=int, default=3)
    sp.add_argument("--snrdb", type=float, default=3.0)
    sp.set_defaults(fn=cmd_scaling_probe)

    sp = sub.add_parser("train-llr", help="train an LLR estimator")
    _add_common(sp)
    sp.add_argument("--snrdb", type=float, default=5.0)
    sp.add_argument("--snr-low", type=float, default=0.0)
    sp.add_argument("--snr-high", type=float, default=0.0)
    sp.add_argument("--tanh", action="store_true")
    sp.add_argument("--lr", type=float, default=0.01)
    sp.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--num-codewords", type=int, default=4096)
    sp.add_argument("--warm-start", default="")
    sp.set_defaults(fn=cmd_train_llr)

    sp = sub.add_parser("train-joint", help="train the joint model")
    _add_common(sp)
    sp.add_argument("--snrdb", type=float, default=5.0)
    sp.add_argument("--lr", type=float, default=0.001)
    sp.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--num-codewords", type=int, default=4096)
    sp.set_defaults(fn=cmd_train_joint)

    sp = sub.add_parser(
        "train-grid",
        help="train the per-SNR model family (unquantized → quantized "
             "warm-start chain); resumable by --family",
    )
    _add_common(sp)
    sp.add_argument("--snr", default="0:10:11")
    sp.add_argument("--qbits-grid", default="1,3,5")
    sp.add_argument("--clipdb-grid", default="0,5")
    sp.add_argument("--lr", type=float, default=0.01)
    sp.add_argument("--quant-lr", type=float, default=0.0,
                    help="stage-2 learning rate (<=0: same as --lr; the "
                         "reference uses 0.1)")
    sp.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--eval-every", type=int, default=10,
                    help="epochs per device-resident training chunk "
                         "(one eval and host read per chunk)")
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--num-codewords", type=int, default=4096)
    sp.add_argument("--family", default="",
                    help="family id (reuse to resume an interrupted grid)")
    sp.set_defaults(fn=cmd_train_grid)

    sp = sub.add_parser(
        "train-minsum",
        help="train per-iteration normalized/offset min-sum weights "
             "(the frozen schedule runs in the kernels' alpha/beta table)",
    )
    _add_common(sp)
    sp.add_argument("--snr-low", type=float, default=1.0)
    sp.add_argument("--snr-high", type=float, default=3.0)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--batch", type=int, default=512)
    sp.add_argument("--lr", type=float, default=0.02)
    sp.add_argument("--optimizer", default="adam",
                    choices=["sgd", "adam"])
    sp.set_defaults(fn=cmd_train_minsum)

    sp = sub.add_parser(
        "evaluate-grid",
        help="evaluate every checkpoint of a trained family at its own "
             "(snr, qbits, clipdb) cell",
    )
    _add_common(sp)
    sp.add_argument("--family", required=True)
    sp.add_argument("--stage", default="quantized",
                    choices=["quantized", "unquantized"])
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--plot", action="store_true",
                    help="write the grid figure under --out (needs "
                         "matplotlib)")
    sp.set_defaults(fn=cmd_evaluate_grid)

    sp = sub.add_parser(
        "noise-study",
        help="quantization-noise statistics grid (per-symbol AGC and a "
             "clean clip, as in the JAX CLI: --agc, --clipdb, "
             "--modulation and --iters do not reach it)",
    )
    _add_common(sp)
    sp.add_argument("--snr", default="0,5,10")
    sp.add_argument("--qbits-grid", default="1,3,5")
    sp.add_argument("--clipdb-grid", default="0")
    sp.add_argument("--batch", type=int, default=512)
    sp.set_defaults(fn=cmd_noise_study)

    sp = sub.add_parser(
        "evaluate-joint",
        help="joint vs classic vs quantized decode (the classic decodes "
             "are sum-product whatever --method says, as in the JAX CLI)",
    )
    _add_common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--snr", default="0:6:4")
    sp.add_argument("--batch", type=int, default=1024)
    sp.set_defaults(fn=cmd_evaluate_joint)

    sp = sub.add_parser("generate-data", help="write a dataset .npz")
    _add_common(sp)
    sp.add_argument("--snrdb", type=float, default=5.0)
    sp.add_argument("--num-codewords", type=int, default=4096)
    sp.set_defaults(fn=cmd_generate_data)

    sp = sub.add_parser(
        "code-info",
        help="analyze a code: degrees, QC cycle spectrum, DE threshold "
             "(validates imported standard shift tables / alists)",
    )
    sp.add_argument("--code", default="ref6432")
    sp.add_argument("--base-file", default="",
                    help="QC shift-table text file (load_qc_base format)")
    sp.add_argument("--alist", default="", help="alist file to analyze")
    sp.add_argument("--de", action="store_true",
                    help="also compute min-sum/sum-product DE thresholds "
                         "(sampled density evolution, on --device)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_code_info)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
