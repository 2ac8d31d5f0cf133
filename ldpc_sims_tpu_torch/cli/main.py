"""Command-line interface: the ``sweep`` subcommand of the JAX package's CLI.

    python -m ldpc_sims_tpu_torch sweep --code wifi1944 --iters 20 \\
        --snr 1.5,2.0 --batch 32768 --max-bits 1e9
    python -m ldpc_sims_tpu_torch sweep --schedule layered --iters 8 \\
        --bp-alpha 0.86,0.86,... --bp-beta 0.12,0.14,...

Defaults are the main path: (1944,972), QPSK over OFDM-32, flooding-20
min-sum, on the card. ``--device cpu`` runs the plain version. Presets
and the other subcommands are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

__all__ = ["build_parser", "main"]


def _parse_snr(spec: str) -> tuple[float, ...]:
    """'0:10:11' → linspace(0, 10, 11); '1,2,3' → those points."""
    if ":" in spec:
        lo, hi, n = spec.split(":")
        return tuple(np.linspace(float(lo), float(hi), int(n)).tolist())
    return tuple(float(s) for s in spec.split(","))


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


def cmd_sweep(args) -> None:
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig
    from ldpc_sims_tpu_torch.parallel import SweepConfig, run_sweep

    code = get_code(args.code)
    link = LinkConfig(
        modulation=args.modulation,
        ofdm_size=args.ofdm_size,
        bp_iterations=args.iters,
        bp_method=args.method,
        bp_schedule=args.schedule,
        alpha=args.bp_alpha,
        beta=args.bp_beta,
        clamp=args.clamp if args.clamp > 0 else None,
    )
    sweep = SweepConfig(
        snrdb=_parse_snr(args.snr), batch_cw=args.batch,
        target_frame_errors=args.target_errors,
        max_info_bits=args.max_bits, steps_per_sync=args.steps_per_sync,
        seed=args.seed,
    )
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    manifest = args.manifest or os.path.join(args.out, f"{stamp}_sweep.json")
    result = run_sweep(code, link, sweep, manifest_path=manifest,
                       device=args.device)
    out = {
        "code": code.name,
        "link": dataclasses.asdict(link),
        **result.as_dict(),
    }
    path = os.path.join(args.out, f"{stamp}_curves.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"curves -> {path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ldpc_sims_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("sweep", help="Monte-Carlo BER/BLER sweep")
    sp.add_argument("--code", default="wifi1944")
    sp.add_argument("--modulation", default="qpsk", choices=["bpsk", "qpsk"])
    sp.add_argument("--ofdm-size", type=int, default=32)
    sp.add_argument("--iters", type=int, default=20)
    sp.add_argument("--method", default="min-sum",
                    help="min-sum (other methods are not ported yet)")
    sp.add_argument("--schedule", default="flooding",
                    choices=["flooding", "layered"])
    sp.add_argument("--bp-alpha", default="1.0", type=_parse_ab,
                    help="min-sum normalization: a float or a "
                         "comma-separated per-iteration list")
    sp.add_argument("--bp-beta", default="0.0", type=_parse_ab,
                    help="min-sum offset: a float or a per-iteration list")
    sp.add_argument("--clamp", type=float, default=0.0,
                    help="c2v message clamp (0 = none)")
    sp.add_argument("--snr", default="1.5,2.0",
                    help="symbol SNR grid in dB: 'lo:hi:n' or 'a,b,c'")
    sp.add_argument("--batch", type=int, default=32768)
    sp.add_argument("--target-errors", type=int, default=100)
    sp.add_argument("--max-bits", type=float, default=1e8)
    sp.add_argument("--steps-per-sync", type=int, default=1,
                    help="MC steps per host read of the counts")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--manifest", default="",
                    help="resume/accumulate manifest (default: new file "
                         "in --out)")
    sp.add_argument("--out", default="outputs")
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain version")
    sp.set_defaults(fn=cmd_sweep)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
