"""Diagnostic studies: quantization-noise statistics and the joint model's
cross-check (the port of ``diagnostics.py``).

* :func:`quantization_noise_study`: the effective noise ``q(rx) − tx``
  over a (qbits × snr × clip) grid, as moments and histograms.
* :func:`evaluate_joint`: the same bits decoded three ways (the joint
  model, classic BP on the analytic LLRs, classic BP on the LLRs of the
  quantized signal), BER/BLER side by side.

Both draw their channels on the device of the call (``device``, the card
unless the caller asks for the CPU) and decode through ``bp_decode``, so
a QC code decodes on the CUDA kernels there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.bp import bp_decode
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
from ldpc_sims_tpu_torch.parallel.mc import stable_seed
from ldpc_sims_tpu_torch.utils.device import resolve_device
from ldpc_sims_tpu_torch.utils.metrics import stable_fold_in

__all__ = ["quantization_noise_study", "evaluate_joint"]


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def quantization_noise_study(
    seed: int,
    code: LdpcCode,
    snrdb_grid=(0.0, 5.0, 10.0),
    qbits_grid=(1, 3, 5),
    clip_ratio_grid=(1.0,),
    num_codewords: int = 512,
    ofdm_size: int = 32,
    bins: int = 41,
    agc: str = "per-symbol",
    agc_clip: float = 10.0,
    legacy_clip: bool = False,
    device="cuda",
) -> list[dict[str, Any]]:
    """Effective quantization-noise statistics per grid point.

    Returns one record per (snr, qbits, clip): mean/std/max of
    ``Re{q(rx) − tx}`` (channel noise and ADC error together), the std and
    max of the ADC-only ``Re{q(rx) − rx}``, and a histogram. Point
    (snr, qbits, clip) draws from ``stable_fold_in(seed, snr, qbits,
    clip)``. The defaults are the per-symbol AGC and the clean clip; set
    ``legacy_clip=True`` and ``agc='global'`` for the reference's exact
    path, whose clip bound ``(2^{b−1})·step − 1`` grows the error with
    more ADC bits under a small AGC clip.
    """
    dev = resolve_device(device)
    records = []
    for snrdb in snrdb_grid:
        for qb in qbits_grid:
            for cr in clip_ratio_grid:
                cfg = LinkConfig(
                    bp_iterations=1, qbits=qb, clip_ratio=cr,
                    ofdm_size=ofdm_size, agc=agc, agc_clip=agc_clip,
                    legacy_clip=legacy_clip,
                )
                gen = _generator(dev, stable_fold_in(seed, snrdb, qb, cr))
                with torch.no_grad():
                    out = link_step(gen, float(snrdb), code, cfg,
                                    num_codewords, return_arrays=True)
                # q(rx) − tx: channel noise + ADC error combined, and the
                # ADC-only contribution q(rx) − rx
                re = (out["q_time"] - out["tx_time"]).real.reshape(-1)
                re_adc = (out["q_time"] - out["rx_time"]).real.reshape(-1)
                re = re.cpu().numpy()
                re_adc = re_adc.cpu().numpy()
                hist, edges = np.histogram(re, bins=bins)
                records.append({
                    "snrdb": float(snrdb),
                    "qbits": int(qb),
                    "clip_ratio": float(cr),
                    "mean": float(re.mean()),
                    "std": float(re.std()),
                    "max_abs": float(np.abs(re).max()),
                    "std_adc": float(re_adc.std()),
                    "max_abs_adc": float(np.abs(re_adc).max()),
                    "hist": hist.tolist(),
                    "bin_edges": edges.tolist(),
                })
    return records


def evaluate_joint(
    joint_model,
    joint_params: Any,
    code: LdpcCode,
    link_cfg: LinkConfig,
    snrdb_grid=(0.0, 2.0, 4.0, 6.0),
    num_codewords: int = 1024,
    seed: int = 0,
    log=print,
    device="cuda",
) -> dict[str, list]:
    """Joint vs classic vs quantized decode on identical bits.

    ``joint_model``: a :class:`..models.Joint`; ``joint_params``: None to
    use its weights, or a flax tree ``{"params": ...}`` or state dict to
    load into it first. Every curve is computed from the same transmitted
    codewords and the same channel noise (one generator an SNR index,
    ``stable_seed(seed, i)``), so differences are receiver differences.
    ``ber_*`` counts the info bits ``[:, :k]`` over ``num_codewords · k``,
    ``bler_*`` the whole codeword over ``num_codewords``. The classic
    decodes are ``bp_decode(method='sum-product')`` with the link's
    iterations and clamp, whatever ``link_cfg.bp_method`` says, as in the
    JAX package.
    """
    from ldpc_sims_tpu_torch.convert import joint_state_dict_from_flax

    dev = resolve_device(device)
    k = code.k
    if joint_params is not None:
        joint_model.load_state_dict(
            joint_state_dict_from_flax(joint_params)
            if "params" in joint_params or "LLRest" in joint_params
            else joint_params)
    joint_model = joint_model.to(dev).eval()

    def step(gen: torch.Generator, snrdb: float) -> dict[str, torch.Tensor]:
        out = link_step(gen, snrdb, code, link_cfg, num_codewords,
                        return_arrays=True)
        coded = out["coded"]
        res = {}

        def count(bits, tag):
            res[f"ber_{tag}"] = (bits[:, :k] != coded[:, :k]).sum()
            res[f"bler_{tag}"] = (bits != coded).any(dim=1).sum()

        def classic(llrs):
            return bp_decode(llrs, code, iterations=link_cfg.bp_iterations,
                             method="sum-product", clamp=link_cfg.clamp)

        count(classic(out["llrs"]), "classic")
        if link_cfg.qbits is not None:
            count(classic(out["qllrs"]), "quantized")
        # the joint model: per-symbol inputs → soft bits
        sig = out["q_time"] if link_cfg.qbits is not None else out["rx_time"]
        flat = sig.reshape(-1, sig.shape[-1])
        x = torch.cat([flat.real, flat.imag], dim=1)
        count((joint_model(x) > 0.5).to(torch.int8), "joint")
        return res

    curves: dict[str, list] = {"snrdb": [float(s) for s in snrdb_grid]}
    for i, snrdb in enumerate(snrdb_grid):
        with torch.no_grad():
            res = step(_generator(dev, stable_seed(seed, i)), float(snrdb))
        vals = torch.stack([v.to(torch.float64) for v in res.values()])
        for kk, v in zip(res, vals.tolist()):
            denom = num_codewords * (k if kk.startswith("ber") else 1)
            curves.setdefault(kk, []).append(v / denom)
        if log:
            log(
                f"snr={snrdb:5.2f}  "
                + "  ".join(
                    f"{kk}={curves[kk][-1]:.3e}"
                    for kk in sorted(curves)
                    if kk != "snrdb"
                )
            )
    return curves
