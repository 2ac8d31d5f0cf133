"""The end-to-end link: bits → encode → OFDM → AWGN → LLR → BP → errors.

The port of ``ops/chain.py``. One call simulates one Monte-Carlo block on
the device of the ``torch.Generator`` it is given; the error counts stay
on that device as 0-d int32 tensors until the sweep engine reads them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops import phy
from ldpc_sims_tpu_torch.ops.bp import bp_decode
from ldpc_sims_tpu_torch.ops.encode import encode

__all__ = ["LinkConfig", "link_step", "BITS_PER_SYMBOL"]

BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4}


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Static configuration of the link chain; the JAX package's fields
    and defaults. Defaults replicate the reference experiment family:
    QPSK over 32-subcarrier OFDM, analytic LLRs, sum-product BP with
    clamp 20 (the port decodes min-sum only so far: pass
    ``bp_method='min-sum'``)."""

    ofdm_size: int = 32
    modulation: str = "qpsk"
    cyclic_prefix: int = 0
    # decoder
    bp_iterations: int = 3
    bp_method: str = "sum-product-ref"
    bp_schedule: str = "flooding"  # 'layered' = serial-C (QC codes only)
    bp_layered_group: int = 1
    clamp: float | None = 20.0
    # scalar, or a per-iteration tuple (a frozen weighted-min-sum schedule)
    alpha: float | tuple[float, ...] = 1.0
    beta: float | tuple[float, ...] = 0.0
    early_stop: bool = False
    es_mode: str = "freeze"
    es_check_every: int = 1
    es_probe_iters: int = 4
    es_probe_alpha: float | tuple[float, ...] | None = None
    es_probe_beta: float | tuple[float, ...] | None = None
    msg_qbits: int | None = None
    msg_qclip: float = 20.0
    # quantized-ADC path (None = ideal ADC)
    qbits: int | None = None
    clip_ratio: float = 1.0
    agc: str = "global"
    agc_clip: float = 10.0
    legacy_clip: bool = True
    # per-OFDM-symbol random SNR
    snr_per_symbol: bool = False
    snrdb_low: float = 0.0
    snrdb_high: float = 0.0

    def bits_per_codeword_symbols(self, n: int) -> int:
        return n // BITS_PER_SYMBOL[self.modulation]


def _check_ported(cfg: LinkConfig, weights) -> None:
    if cfg.modulation not in ("bpsk", "qpsk"):
        raise NotImplementedError(
            f"modulation {cfg.modulation!r} is not ported yet (ROADMAP A5)"
        )
    if cfg.qbits is not None:
        raise NotImplementedError(
            "the quantized-ADC branch (qbits) is not ported yet (ROADMAP A5)"
        )
    if cfg.snr_per_symbol:
        raise NotImplementedError(
            "snr_per_symbol is not ported yet (ROADMAP A5)"
        )
    if weights is not None:
        raise NotImplementedError(
            "decoder weights are not ported yet (ROADMAP A10 and B7)"
        )


def link_step(
    gen: torch.Generator,
    snrdb,
    code: LdpcCode,
    cfg: LinkConfig,
    batch_cw: int,
    weights=None,
    return_arrays: bool = False,
) -> dict[str, torch.Tensor]:
    """Simulate ``batch_cw`` codewords through the full chain at ``snrdb``.

    Draws the info bits, then the channel noise, from ``gen``; runs on
    ``gen.device``. Returns raw error counts and denominators (0-d int32
    tensors): uncoded/coded bit errors and frame errors. Coded BER counts
    the info bits ``[:, :k]``, BLER the full codeword. With
    ``return_arrays=True`` also returns the LLRs, coded bits and time
    samples.
    """
    _check_ported(cfg, weights)
    n, k = code.n, code.k
    bps = BITS_PER_SYMBOL[cfg.modulation]
    sym_per_cw = n // bps
    # the coded stream is modulated as one flat sequence: OFDM blocks need
    # not align to codewords. Group the fewest codewords per row so rows
    # tile the OFDM size (g = 8 for n=1944, QPSK, OFDM-32).
    g = math.lcm(sym_per_cw, cfg.ofdm_size) // sym_per_cw
    if batch_cw % g:
        raise ValueError(
            f"batch_cw must be a multiple of {g} for n={n}, "
            f"{cfg.modulation}, ofdm_size={cfg.ofdm_size}"
        )
    rows = batch_cw // g
    dev = gen.device

    info = phy.random_bits(gen, (batch_cw, k))
    coded = encode(info, code)
    mod = phy.modulate_qpsk if cfg.modulation == "qpsk" else phy.modulate_bpsk
    tx_sym = mod(coded)  # (B, S)

    tx_time = phy.ofdm_modulate(tx_sym.reshape(rows, -1), cfg.ofdm_size)
    if cfg.cyclic_prefix:
        tx_time = phy.add_cyclic_prefix(tx_time, cfg.cyclic_prefix)

    snr = 10.0 ** (torch.as_tensor(snrdb, dtype=torch.float32, device=dev)
                   / 10.0)
    rx_time = phy.awgn(gen, tx_time, snr)

    rx = rx_time
    if cfg.cyclic_prefix:
        rx = phy.remove_cyclic_prefix(rx, cfg.cyclic_prefix)
    rx_sym = phy.ofdm_demodulate(rx)  # (rows, g·S)
    llr_fn = (phy.demodulate_qpsk_llr if cfg.modulation == "qpsk"
              else phy.bpsk_llr)
    llrs = llr_fn(rx_sym, snr).reshape(batch_cw, n)

    bits_est = bp_decode(
        llrs,
        code,
        iterations=cfg.bp_iterations,
        method=cfg.bp_method,
        alpha=cfg.alpha,
        beta=cfg.beta,
        clamp=cfg.clamp,
        early_stop=cfg.early_stop,
        es_mode=cfg.es_mode,
        layered_group=cfg.bp_layered_group,
        msg_qbits=cfg.msg_qbits,
        output="hard",
        schedule=cfg.bp_schedule,
    )

    i32 = torch.int32
    uncoded_est = (llrs > 0).to(torch.int8)
    info_err = (bits_est[:, :k] != coded[:, :k]).sum(dtype=i32)
    frame_err = (bits_est != coded).any(dim=1).sum(dtype=i32)
    out = dict(
        uncoded_bit_errors=(uncoded_est != coded).sum(dtype=i32),
        coded_bit_errors=info_err,
        frame_errors=frame_err,
        uncoded_bits=torch.full((), batch_cw * n, dtype=i32, device=dev),
        info_bits=torch.full((), batch_cw * k, dtype=i32, device=dev),
        frames=torch.full((), batch_cw, dtype=i32, device=dev),
    )
    if return_arrays:
        def strip(t):
            return (phy.remove_cyclic_prefix(t, cfg.cyclic_prefix)
                    if cfg.cyclic_prefix else t)

        out.update(llrs=llrs, coded=coded, rx_time=strip(rx_time),
                   tx_time=strip(tx_time),
                   snr_sym=snr.expand(rows, tx_time.shape[1]))
    return out
