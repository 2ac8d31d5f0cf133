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
from ldpc_sims_tpu_torch.utils.metrics import (
    LINK_COUNTS,
    LINK_DECODE,
    LINK_ENCODE,
    LINK_PHY,
    span,
)

__all__ = ["LinkConfig", "link_step", "BITS_PER_SYMBOL"]

BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4}
_MODULATE = {"bpsk": phy.modulate_bpsk, "qpsk": phy.modulate_qpsk,
             "qam16": phy.modulate_qam16}
_LLR = {"bpsk": phy.bpsk_llr, "qpsk": phy.demodulate_qpsk_llr,
        "qam16": phy.qam16_llr}


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Static configuration of the link chain; the JAX package's fields
    and defaults. Defaults replicate the reference experiment family:
    QPSK over 32-subcarrier OFDM, analytic LLRs, reference sum-product BP
    with clamp 20 (``sum-product-ref`` is not ported yet: pass
    ``bp_method='min-sum'`` or ``'sum-product'``)."""

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
    agc: str = "global"  # 'global' | 'per-symbol'
    agc_clip: float = 10.0
    legacy_clip: bool = True
    # per-OFDM-symbol random SNR
    snr_per_symbol: bool = False
    snrdb_low: float = 0.0
    snrdb_high: float = 0.0

    def bits_per_codeword_symbols(self, n: int) -> int:
        return n // BITS_PER_SYMBOL[self.modulation]


def _check_config(cfg: LinkConfig) -> None:
    if cfg.modulation not in BITS_PER_SYMBOL:
        raise ValueError(f"unknown modulation {cfg.modulation!r}")
    if cfg.qbits is not None and cfg.agc not in ("global", "per-symbol"):
        raise ValueError(f"unknown agc {cfg.agc!r}")


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

    Draws the info bits, then (with ``cfg.snr_per_symbol``) the SNRs,
    then the channel noise, from ``gen``; runs on ``gen.device``. Returns
    raw error counts and denominators (0-d int32 tensors): uncoded/coded
    bit errors and frame errors. Coded BER counts
    the info bits ``[:, :k]``, BLER the full codeword. With ``cfg.qbits``
    the receiver's ADC quantizes the time samples (CP included) after the
    ``cfg.agc`` gain control and the decoder takes the LLRs of the
    quantized samples; the uncoded BER still counts the ideal ADC's LLRs,
    as in the JAX package. ``cfg.snr_per_symbol`` gives each OFDM symbol
    its own SNR, uniform in dB over ``[cfg.snrdb_low, cfg.snrdb_high]``,
    which its noise, its subcarriers' LLRs and the per-symbol AGC take
    (``snrdb`` is then ignored), as in the JAX package's random-SNR
    family. ``weights``: decoder weights for ``bp_decode``
    (JAX's dict, or :func:`..ops.bp.pack_decoder_weights`'s, which the
    sweep engine makes once). With ``return_arrays=True`` also returns the
    LLRs, coded bits, time samples and the linear SNR of each OFDM symbol
    (``snr_sym``, rows × symbols a row), and the quantized LLRs and
    samples with ``qbits``. While a profiler records, the encode, the
    channel and LLRs, the decode and the counts are spans
    (:func:`..utils.metrics.span`), and the decode's iterations are
    counted (an early-stop decode reports them per codeword).
    """
    _check_config(cfg)
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

    with span(LINK_ENCODE, dev):
        info = phy.random_bits(gen, (batch_cw, k))
        coded = encode(info, code)
    with span(LINK_PHY, dev):
        tx_sym = _MODULATE[cfg.modulation](coded)  # (B, S)

        tx_time = phy.ofdm_modulate(tx_sym.reshape(rows, -1), cfg.ofdm_size)
        if cfg.cyclic_prefix:
            tx_time = phy.add_cyclic_prefix(tx_time, cfg.cyclic_prefix)

        n_ofdm = tx_time.shape[1]
        if cfg.snr_per_symbol:
            # one SNR an OFDM symbol, uniform in dB over [low, high]
            u = torch.rand((rows, n_ofdm), generator=gen, device=dev)
            snrdb_sym = cfg.snrdb_low + (cfg.snrdb_high - cfg.snrdb_low) * u
            snr = 10.0 ** (snrdb_sym / 10.0)  # (rows, n_ofdm)
            snr_bc = snr[..., None]
            # each subcarrier's LLR takes its OFDM symbol's SNR
            snr_llr = snr.repeat_interleave(cfg.ofdm_size, dim=1)
        else:
            snr = 10.0 ** (torch.as_tensor(snrdb, dtype=torch.float32,
                                           device=dev) / 10.0)
            snr_bc = snr_llr = snr
        rx_time = phy.awgn(gen, tx_time, snr_bc)

        def demod_and_llr(samples):
            if cfg.cyclic_prefix:
                samples = phy.remove_cyclic_prefix(samples, cfg.cyclic_prefix)
            rx_sym = phy.ofdm_demodulate(samples)  # (rows, g·S)
            return _LLR[cfg.modulation](rx_sym, snr_llr).reshape(batch_cw, n)

        llrs = demod_and_llr(rx_time)
        decode_llrs = llrs
        if cfg.qbits is not None:
            if cfg.agc == "global":
                clip = phy.agc_global(rx_time) * cfg.clip_ratio
                q_time = phy.quantize_complex(rx_time, cfg.qbits, clip,
                                              cfg.legacy_clip)
            else:  # per OFDM symbol, from the known SNR
                factor = phy.agc_per_symbol(
                    snr.expand(rows, n_ofdm), cfg.agc_clip,
                    cfg.clip_ratio)[..., None]
                q = phy.quantize_complex(rx_time * factor, cfg.qbits,
                                         cfg.agc_clip, cfg.legacy_clip)
                q_time = q / factor
            decode_llrs = demod_and_llr(q_time)

    with span(LINK_DECODE, dev) as rec:
        bits_est = bp_decode(
            decode_llrs,
            code,
            iterations=cfg.bp_iterations,
            method=cfg.bp_method,
            alpha=cfg.alpha,
            beta=cfg.beta,
            clamp=cfg.clamp,
            early_stop=cfg.early_stop,
            es_mode=cfg.es_mode,
            es_check_every=cfg.es_check_every,
            es_probe_iters=cfg.es_probe_iters,
            es_probe_alpha=cfg.es_probe_alpha,
            es_probe_beta=cfg.es_probe_beta,
            layered_group=cfg.bp_layered_group,
            msg_qbits=cfg.msg_qbits,
            msg_qclip=cfg.msg_qclip,
            weights=weights,
            output="hard_iters" if rec and cfg.early_stop else "hard",
            schedule=cfg.bp_schedule,
        )
        if rec:
            bits_est = rec.count_iterations(bits_est, cfg.bp_iterations,
                                            batch_cw)

    with span(LINK_COUNTS, dev):
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
                   snr_sym=snr.expand(rows, n_ofdm))
        if cfg.qbits is not None:
            out.update(qllrs=decode_llrs, q_time=strip(q_time))
    return out
