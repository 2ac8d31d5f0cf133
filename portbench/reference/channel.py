"""One Monte-Carlo block of the QPSK / OFDM / AWGN link, in plain PyTorch.

The draws are those of a ``torch.Generator`` seeded with the step's seed on
the device: the info bits (``randint``, int8, (batch, k)), then the real
and the imaginary parts of the noise (``randn``, one call each, of the
time samples' shape). The arithmetic is float32, written out as the
configuration states it.
"""

from __future__ import annotations

import math

import torch

from .decode import store

INV_SQRT2 = 0.7071067811865476


def transmit(gen: torch.Generator, code, batch: int, ofdm_size: int,
             snrdb: float, storage: str = "float32"):
    """(coded int8 (B, n), channel LLRs f32 (B, n), log(Pr1/Pr0)).
    ``storage='bfloat16'`` rounds every float tensor of the chain to
    bfloat16 as it is made (the control)."""
    st = store(storage)
    dev = gen.device
    n, k = code.n, code.k
    info = torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                         dtype=torch.int8)
    coded = code.encode(info)
    b = coded.reshape(batch, -1, 2).to(torch.float32)
    sym = st(torch.complex((1.0 - 2.0 * b[..., 0]) * INV_SQRT2,
                           (1.0 - 2.0 * b[..., 1]) * INV_SQRT2))
    # codewords run on as one stream: the fewest a row that fill OFDM
    # symbols whole
    per_cw = n // 2
    group = math.lcm(per_cw, ofdm_size) // per_cw
    rows = batch // group
    blocks = sym.reshape(rows, -1).reshape(rows, -1, ofdm_size)
    tx = st(torch.fft.ifft(blocks, dim=-1) * (float(ofdm_size) ** 0.5))
    snr = 10.0 ** (torch.as_tensor(snrdb, dtype=torch.float32,
                                   device=dev) / 10.0)
    sigma = 1.0 / torch.sqrt(2.0 * snr)
    re = torch.randn(tx.shape, generator=gen, device=dev)
    im = torch.randn(tx.shape, generator=gen, device=dev)
    rx = st(tx + sigma * st(torch.complex(re, im)))
    y = st(torch.fft.fft(rx, dim=-1) / (float(ofdm_size) ** 0.5)).reshape(
        rows, -1)
    two_var = 2.0 * (0.5 * (1.0 / snr))
    l0 = ((y.real - INV_SQRT2) ** 2 - (y.real + INV_SQRT2) ** 2) / two_var
    l1 = ((y.imag - INV_SQRT2) ** 2 - (y.imag + INV_SQRT2) ** 2) / two_var
    llr = st(torch.stack([l0, l1], dim=-1).reshape(batch, n))
    return coded, llr
