"""The OFDM PHY chain in PyTorch (the port of ``ops/phy.py``, main path).

Shapes and conventions are the JAX package's: bits and LLR streams are
``(batch, num)``; OFDM symbol blocks ``(batch, n_sym, ofdm_size)``,
complex64. QPSK Gray map (b0, b1) → ((1−2 b0) + j(1−2 b1))/√2; 16-QAM
Gray map per axis (s, m) → (1−2s)(3−2m)/√10; AWGN with per-complex-component
σ² = 1/(2·snr), snr the linear symbol SNR; exact per-bit Gaussian LLRs in
the log(Pr1/Pr0) convention; unitary DFTs; the reference's uniform ADC
quantizer and its two AGCs. Randomness comes from an explicit
``torch.Generator`` and lands on its device.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "random_bits",
    "modulate_qpsk",
    "demodulate_qpsk_llr",
    "modulate_bpsk",
    "bpsk_llr",
    "modulate_qam16",
    "qam16_llr",
    "ofdm_modulate",
    "ofdm_demodulate",
    "awgn",
    "add_cyclic_prefix",
    "remove_cyclic_prefix",
    "quantize_complex",
    "agc_global",
    "agc_per_symbol",
    "ebn0db_to_snrdb",
    "snrdb_to_ebn0db",
    "weighted_mse",
    "bit_errors",
]

_INV_SQRT2 = 0.7071067811865476


def random_bits(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Uniform random int8 bits on the generator's device."""
    return torch.randint(0, 2, shape, generator=gen, device=gen.device,
                         dtype=torch.int8)


def modulate_qpsk(bits: torch.Tensor) -> torch.Tensor:
    """(batch, 2S) bits → (batch, S) complex64 QPSK symbols."""
    b = bits.reshape(bits.shape[0], -1, 2).to(torch.float32)
    re = (1.0 - 2.0 * b[..., 0]) * _INV_SQRT2
    im = (1.0 - 2.0 * b[..., 1]) * _INV_SQRT2
    return torch.complex(re, im)


def demodulate_qpsk_llr(sym: torch.Tensor, snr) -> torch.Tensor:
    """Exact per-bit Gaussian LLRs, log(Pr1/Pr0), in the reference's
    expanded form ((r∓1/√2)² − (r±1/√2)²)/(2σ²), σ² = 1/(2 snr)."""
    noise_power = 0.5 * (1.0 / snr)
    re, im = sym.real, sym.imag
    llr0 = ((re - _INV_SQRT2) ** 2 - (re + _INV_SQRT2) ** 2) / (
        2.0 * noise_power
    )
    llr1 = ((im - _INV_SQRT2) ** 2 - (im + _INV_SQRT2) ** 2) / (
        2.0 * noise_power
    )
    return torch.stack([llr0, llr1], dim=-1).reshape(sym.shape[0], -1)


def modulate_bpsk(bits: torch.Tensor) -> torch.Tensor:
    """bits → ±1 real symbols as complex (0→+1, 1→−1)."""
    b = bits.to(torch.float32)
    return torch.complex(1.0 - 2.0 * b, torch.zeros_like(b))


def bpsk_llr(sym: torch.Tensor, snr) -> torch.Tensor:
    """BPSK LLRs log(Pr1/Pr0) for unit-energy ±1, σ² = 1/(2 snr)/comp."""
    noise_power = 0.5 * (1.0 / snr)
    re = sym.real
    return ((re - 1.0) ** 2 - (re + 1.0) ** 2) / (2.0 * noise_power)


def _inv_sqrt10(device) -> torch.Tensor:
    """1/√10 rounded as the JAX package rounds it (f32 sqrt, f32 divide)."""
    return 1.0 / torch.sqrt(torch.tensor(10.0, device=device))


def modulate_qam16(bits: torch.Tensor) -> torch.Tensor:
    """(batch, 4S) bits → (batch, S) Gray-mapped 16-QAM, unit energy.

    Per axis, bits (s, m): level = (1−2s)·(3−2m)/√10 (s the sign bit, m
    the magnitude bit)."""
    b = bits.reshape(bits.shape[0], -1, 4).to(torch.float32)
    scale = _inv_sqrt10(bits.device)
    re = (1.0 - 2.0 * b[..., 0]) * (3.0 - 2.0 * b[..., 1]) * scale
    im = (1.0 - 2.0 * b[..., 2]) * (3.0 - 2.0 * b[..., 3]) * scale
    return torch.complex(re, im)


def qam16_llr(sym: torch.Tensor, snr) -> torch.Tensor:
    """Exact 16-QAM LLRs, log(Pr1/Pr0), σ² = 1/(2 snr) per component.

    Full enumeration over the 4 levels of each axis with an exact
    log-sum-exp (not max-log)."""
    dev = sym.device
    snr = torch.as_tensor(snr, dtype=torch.float32, device=dev)
    noise_power = torch.broadcast_to(0.5 * (1.0 / snr), sym.shape)
    levels = torch.tensor([-3.0, -1.0, 1.0, 3.0], device=dev) \
        * _inv_sqrt10(dev)
    # the Gray map's bits per level: -3: s=1,m=0; -1: s=1,m=1;
    # +1: s=0,m=1; +3: s=0,m=0
    s_bit = torch.tensor([True, True, False, False], device=dev)
    m_bit = torch.tensor([False, True, True, False], device=dev)
    ninf = torch.tensor(-torch.inf, device=dev)

    def axis_llrs(r):
        d = -((r[..., None] - levels) ** 2) / (2.0 * noise_power[..., None])

        def bit_llr(bit_of_level):
            on = torch.logsumexp(torch.where(bit_of_level, d, ninf), -1)
            off = torch.logsumexp(torch.where(bit_of_level, ninf, d), -1)
            return on - off

        return bit_llr(s_bit), bit_llr(m_bit)

    l0, l1 = axis_llrs(sym.real)
    l2, l3 = axis_llrs(sym.imag)
    return torch.stack([l0, l1, l2, l3], dim=-1).reshape(sym.shape[0], -1)


def ofdm_modulate(symbols: torch.Tensor, ofdm_size: int) -> torch.Tensor:
    """(batch, S) frequency-domain symbols → (batch, S//N, N) time samples
    (unitary IDFT: ``ifft · √N``)."""
    blocks = symbols.reshape(symbols.shape[0], -1, ofdm_size)
    return torch.fft.ifft(blocks, dim=-1) * (float(ofdm_size) ** 0.5)


def ofdm_demodulate(samples: torch.Tensor) -> torch.Tensor:
    """Time-domain blocks → (batch, S) frequency-domain symbols (unitary
    DFT)."""
    n = samples.shape[-1]
    out = torch.fft.fft(samples, dim=-1) / (float(n) ** 0.5)
    return out.reshape(samples.shape[0], -1)


def add_cyclic_prefix(blocks: torch.Tensor, cp: int) -> torch.Tensor:
    """(batch, S, N) → (batch, S, cp+N)."""
    return torch.cat([blocks[..., -cp:], blocks], dim=-1)


def remove_cyclic_prefix(blocks: torch.Tensor, cp: int) -> torch.Tensor:
    return blocks[..., cp:]


def awgn(gen: torch.Generator, samples: torch.Tensor, snr) -> torch.Tensor:
    """Complex AWGN, per-component σ = 1/√(2 snr); ``snr`` (linear)
    broadcasts against ``samples``."""
    sigma = 1.0 / torch.sqrt(2.0 * torch.as_tensor(
        snr, dtype=torch.float32, device=samples.device))
    shape = samples.shape
    re = torch.randn(shape, generator=gen, device=samples.device)
    im = torch.randn(shape, generator=gen, device=samples.device)
    return samples + sigma * torch.complex(re, im)


# --- quantizer / AGC -----------------------------------------------------


def _f32(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``: dividing a CUDA tensor by a
    Python scalar multiplies by its reciprocal, by a tensor it divides."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def quantize_complex(x: torch.Tensor, num_bits: int, clip_value,
                     legacy_clip: bool = True) -> torch.Tensor:
    """Uniform mid-rise ADC quantizer on I and Q independently.

    step = 2·clip/(2^b − 1), value = floor(x/step + 0.5)·step (halves go
    up). ``legacy_clip=True`` keeps the reference's clip bound
    ±((2^{b−1})·step − 1), the "− 1" outside the product; False clips to
    ±(2^{b−1} − 1)·step, a symmetric quantizer with 2^b − 1 levels.
    """
    levels = 2**num_bits
    clip = _f32(clip_value, x.device)
    step = 2.0 * clip / _f32(levels - 1, x.device)
    re = torch.floor(x.real / step + 0.5) * step
    im = torch.floor(x.imag / step + 0.5) * step
    if legacy_clip:
        hi = (levels / 2) * step - 1.0
        lo = -(levels / 2) * step + 1.0
    else:
        hi = (levels / 2 - 1) * step
        lo = -hi
    return torch.complex(torch.clamp(re, lo, hi), torch.clamp(im, lo, hi))


def agc_global(rx: torch.Tensor) -> torch.Tensor:
    """Batch-global AGC statistic: the std of the complex stream,
    √E[|x − E[x]|²] (NumPy's complex std, as the reference takes it)."""
    mu = rx.mean()
    return torch.sqrt(((rx - mu).abs() ** 2).mean())


def agc_per_symbol(snr: torch.Tensor, agc_clip: float = 10.0,
                   clip_ratio: float = 1.0) -> torch.Tensor:
    """Per-OFDM-symbol AGC factor: σ_rx = 0.5·(1 + 1/snr), factor =
    agc_clip/σ_rx·clip_ratio. The caller scales by it, quantizes with the
    fixed ``agc_clip`` and scales back."""
    snr = torch.as_tensor(snr, dtype=torch.float32)
    sigma_rx = 0.5 * (1.0 + 1.0 / snr)  # 1/x: a reciprocal, exact as JAX's
    return _f32(agc_clip, snr.device) / sigma_rx * clip_ratio


def ebn0db_to_snrdb(ebn0_db, rate: float, bits_per_symbol: int):
    """Eb/N0 (dB) → symbol SNR Es/N0 (dB): Es = Eb · rate · bits/symbol.
    Takes and returns a float or a tensor."""
    return ebn0_db + 10.0 * math.log10(rate * bits_per_symbol)


def snrdb_to_ebn0db(snrdb, rate: float, bits_per_symbol: int):
    """Symbol SNR Es/N0 (dB) → Eb/N0 (dB), the inverse of
    :func:`ebn0db_to_snrdb`."""
    return snrdb - 10.0 * math.log10(rate * bits_per_symbol)


def weighted_mse(llr_est: torch.Tensor, llr: torch.Tensor,
                 epsilon: float = 0.001) -> torch.Tensor:
    """mean((est − llr)² / (|llr| + ε)) (``ofdm_functions.py:80-81``)."""
    return torch.mean((llr_est - llr) ** 2 / (torch.abs(llr) + epsilon))


def bit_errors(bits_est: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Total differing bits (``compute_ber`` numerator,
    ``ofdm_functions.py:83-84``), int32 as in the JAX package."""
    return torch.sum(torch.abs(bits_est.to(torch.int32)
                               - bits.to(torch.int32)), dtype=torch.int32)
