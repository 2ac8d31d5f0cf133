"""BER/BLER/WMSE evaluation sweeps, including the learned receivers (the
port of ``evaluate.py``).

One call sweeps the SNR grid computing, per point and on the same bits,

* uncoded BER (hard decisions on the analytic LLRs),
* "Traditional" coded BER/BLER — BP on the analytic LLRs,
* quantized coded BER/BLER — BP on the LLRs of the quantized signal
  (with ``link_cfg.qbits``), and the WMSE of those LLRs,
* NN coded BER/BLER — BP on a neural estimator's LLRs, with their WMSE
  (and, for the tanh model, the WMSE where the estimate's sign is wrong).

Every decode takes the link's decode flags and ``weights``, and goes
through ``bp_decode``, so on a QC code on the card it launches the CUDA
kernels. ``link_step`` decodes the LLRs the link's receiver sees (the
quantized ones with ``qbits``, else the analytic ones) and its counts are
that curve's; the JAX package discards them and decodes those LLRs again.

Seeds. Point ``i``, batch ``b`` draws from ``stable_seed(seed, i, b)``
(the JAX package: ``fold_in(fold_in(key(seed), i), b)``), and over a
mesh each rank from that seed's shard (``parallel.mc.shard_seed``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.bp import bp_decode, pack_decoder_weights
from ldpc_sims_tpu_torch.ops.chain import BITS_PER_SYMBOL, LinkConfig, link_step
from ldpc_sims_tpu_torch.ops.phy import weighted_mse
from ldpc_sims_tpu_torch.parallel.mc import shard_seed, stable_seed
from ldpc_sims_tpu_torch.parallel.mesh import local_batch_multiple, make_mesh
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = ["EvalConfig", "evaluate_sweep", "invert_tanh", "nn_llrs"]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    snrdb: tuple[float, ...] = tuple(float(s) for s in range(0, 11))
    num_codewords: int = 4096
    batches: int = 1
    with_snr_feature: bool = False
    tanh_model: bool = False  # model outputs tanh(llr): invert it
    seed: int = 0


def invert_tanh(est: torch.Tensor) -> torch.Tensor:
    """The tanh model's inversion, as the JAX package computes it: clip
    to ±(1 − 1e−7) in float32, then ``0.5·log((1 + e)/(1 − e))`` (not
    ``atanh``, whose rounding differs)."""
    est = torch.clamp(est, -1 + 1e-7, 1 - 1e-7)
    return 0.5 * torch.log((1 + est) / (1 - est))


def nn_llrs(model, x: torch.Tensor, tanh_model: bool) -> torch.Tensor:
    """The estimator's LLRs for input rows ``x`` (no gradient)."""
    with torch.no_grad():
        est = model(x)
    return invert_tanh(est) if tanh_model else est


def evaluate_sweep(
    code: LdpcCode,
    link_cfg: LinkConfig,
    eval_cfg: EvalConfig,
    model=None,
    weights=None,
    log: Callable[[str], None] | None = print,
    mesh=None,
    device="cuda",
) -> dict[str, list]:
    """Run the evaluation sweep; returns curves as plain lists (JSON-able).

    With ``model=None`` only the Traditional (and quantized, with
    ``link_cfg.qbits``) curves; with a model (an estimator of
    :mod:`ldpc_sims_tpu_torch.models` holding its weights) the NN curves
    and WMSE too. Its input is ``concat(real, imag)`` of the time samples
    of each OFDM symbol (the quantized ones with ``qbits``), with the
    symbol's linear SNR appended when ``eval_cfg.with_snr_feature``.
    ``weights``: a decoder-weight dict applied to every decode.

    Over a mesh of N ranks each rank evaluates ``num_codewords / N``
    codewords of every batch; counts are summed and WMSE averaged over
    the mesh (every shard the same size, so the mean of means is exact).
    When ``num_codewords`` does not tile N times the OFDM grouping, every
    rank evaluates the whole batch alone (with the JAX package's
    warning), so all ranks return the same curves either way.
    """
    dev = resolve_device(device)
    k = code.k
    if mesh is None:
        mesh = make_mesh()
    n_dev = local_batch_multiple(mesh)
    sym_per_cw = code.n // BITS_PER_SYMBOL[link_cfg.modulation]
    g = math.lcm(sym_per_cw, link_cfg.ofdm_size) // sym_per_cw
    if eval_cfg.num_codewords % (n_dev * g):
        if n_dev > 1:
            warnings.warn(
                f"num_codewords={eval_cfg.num_codewords} does not tile "
                f"{n_dev} devices x OFDM group {g}; evaluating on a "
                "single shard — pad the batch to a multiple of "
                f"{n_dev * g} to use the mesh",
                stacklevel=2,
            )
        n_dev = 1
    shard = mesh.index if n_dev > 1 else 0
    per_dev = eval_cfg.num_codewords // n_dev
    weights = pack_decoder_weights(weights, code, link_cfg.bp_iterations,
                                   dev)
    if model is not None:
        model = model.to(dev).eval()

    def decode_count(llrs, coded, res, tag):
        bits = bp_decode(
            llrs, code, iterations=link_cfg.bp_iterations,
            method=link_cfg.bp_method, clamp=link_cfg.clamp,
            alpha=link_cfg.alpha, beta=link_cfg.beta,
            early_stop=link_cfg.early_stop, es_mode=link_cfg.es_mode,
            es_check_every=link_cfg.es_check_every,
            es_probe_iters=link_cfg.es_probe_iters,
            es_probe_alpha=link_cfg.es_probe_alpha,
            es_probe_beta=link_cfg.es_probe_beta,
            layered_group=link_cfg.bp_layered_group,
            msg_qbits=link_cfg.msg_qbits, msg_qclip=link_cfg.msg_qclip,
            schedule=link_cfg.bp_schedule, weights=weights, output="hard",
        )
        res[f"coded_errs_{tag}"] = (bits[:, :k] != coded[:, :k]).sum()
        # BLER over the full codeword (evaluate_quantized.py:141)
        res[f"frame_errs_{tag}"] = (bits != coded).any(dim=1).sum()

    def point_step(seed: int, snrdb: float) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = link_step(gen, snrdb, code, link_cfg, per_dev,
                        weights=weights, return_arrays=True)
        coded = out["coded"]
        # link_step decoded the receiver's LLRs: that curve's counts
        seen = "quant" if link_cfg.qbits is not None else "trad"
        res = {
            "uncoded_errs": out["uncoded_bit_errors"],
            "frames": out["frames"],
            f"coded_errs_{seen}": out["coded_bit_errors"],
            f"frame_errs_{seen}": out["frame_errors"],
        }
        if link_cfg.qbits is not None:
            decode_count(out["llrs"], coded, res, "trad")
            res["wmse_quant"] = weighted_mse(
                out["qllrs"].reshape(-1), out["llrs"].reshape(-1), 0.001)
        if model is not None:
            sig = out["q_time"] if link_cfg.qbits is not None else (
                out["rx_time"])
            flat = sig.reshape(-1, sig.shape[-1])
            x = torch.cat([flat.real, flat.imag], dim=1)
            if eval_cfg.with_snr_feature:
                x = torch.cat([x, out["snr_sym"].reshape(-1, 1)], dim=1)
            est_sym = nn_llrs(model, x, eval_cfg.tanh_model)
            est_f = est_sym.reshape(-1)
            llr_f = out["llrs"].reshape(-1)
            res["wmse_nn"] = weighted_mse(est_f, llr_f, 0.001)
            if eval_cfg.tanh_model:
                # flipped-position WMSE (evaluate_quantized_tanh.py:163-170)
                # as num/cnt, so shard and batch sums stay exact
                flip = (torch.sign(est_f) != torch.sign(llr_f)).to(
                    torch.float32)
                w = (est_f - llr_f) ** 2 / (torch.abs(llr_f) + 0.001)
                res["flip_wmse_num"] = torch.sum(flip * w)
                res["flip_wmse_cnt"] = torch.sum(flip)
            decode_count(est_sym.reshape(-1, code.n), coded, res, "nn")
        if n_dev > 1:
            # counts sum across shards; WMSE is a mean of equal-size shard
            # means, so averaging is exact
            names = sorted(res)
            vals = mesh.all_reduce_sum(torch.stack(
                [res[n].to(torch.float64) for n in names]))
            res = {n: (v / n_dev if n.startswith("wmse") else v)
                   for n, v in zip(names, vals.unbind())}
        return res

    curves: dict[str, list] = {"snrdb": list(eval_cfg.snrdb)}
    n_cw = eval_cfg.num_codewords * eval_cfg.batches
    n_unc = n_cw * code.n
    n_info = n_cw * k

    for i, snrdb in enumerate(eval_cfg.snrdb):
        acc: dict[str, float] = {}
        for b in range(eval_cfg.batches):
            seed = shard_seed(stable_seed(eval_cfg.seed, i, b), shard, n_dev)
            res = point_step(seed, float(snrdb))
            names = list(res)
            vals = torch.stack([res[n].to(torch.float64)
                                for n in names]).tolist()
            for kk, v in zip(names, vals):
                acc[kk] = acc.get(kk, 0.0) + v

        def put(name, val):
            curves.setdefault(name, []).append(val)

        put("uncoded_ber", acc["uncoded_errs"] / n_unc)
        put("coded_ber", acc["coded_errs_trad"] / n_info)
        put("coded_bler", acc["frame_errs_trad"] / n_cw)
        if "coded_errs_quant" in acc:
            put("coded_ber_qllr", acc["coded_errs_quant"] / n_info)
            put("coded_bler_qllr", acc["frame_errs_quant"] / n_cw)
            put("wmse_qllr", acc["wmse_quant"] / eval_cfg.batches)
        if "coded_errs_nn" in acc:
            put("coded_ber_nn", acc["coded_errs_nn"] / n_info)
            put("coded_bler_nn", acc["frame_errs_nn"] / n_cw)
            put("wmse_nn", acc["wmse_nn"] / eval_cfg.batches)
        if "flip_wmse_num" in acc:
            put(
                "wmse_nn_flipped",
                acc["flip_wmse_num"] / max(acc["flip_wmse_cnt"], 1.0),
            )
        if log and mesh.is_leader:
            nn = (
                f"  nn={curves['coded_ber_nn'][-1]:.3e}"
                if "coded_ber_nn" in curves
                else ""
            )
            log(
                f"snr={snrdb:5.2f}  uncoded={curves['uncoded_ber'][-1]:.3e}"
                f"  coded={curves['coded_ber'][-1]:.3e}{nn}"
            )
    return curves
