"""The OFDM PHY chain in PyTorch (the port of ``ops/phy.py``, main path).

Shapes and conventions are the JAX package's: bits and LLR streams are
``(batch, num)``; OFDM symbol blocks ``(batch, n_sym, ofdm_size)``,
complex64. QPSK Gray map (b0, b1) → ((1−2 b0) + j(1−2 b1))/√2; AWGN with
per-complex-component σ² = 1/(2·snr), snr the linear symbol SNR; exact
per-bit Gaussian LLRs in the log(Pr1/Pr0) convention; unitary DFTs.
Randomness comes from an explicit ``torch.Generator`` and lands on its
device. The quantizer, the AGCs and 16-QAM are not ported yet
(ROADMAP A5).
"""

from __future__ import annotations

import torch

__all__ = [
    "random_bits",
    "modulate_qpsk",
    "demodulate_qpsk_llr",
    "modulate_bpsk",
    "bpsk_llr",
    "ofdm_modulate",
    "ofdm_demodulate",
    "awgn",
    "add_cyclic_prefix",
    "remove_cyclic_prefix",
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
