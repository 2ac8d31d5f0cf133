"""Systematic LDPC encoding on the device (the port of ``ops/encode.py``)."""

from __future__ import annotations

import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode

__all__ = ["encode"]


def encode(u: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """(batch, k) info bits → (batch, n) int8 codewords.

    ``c[perm] = G·u mod 2`` with G the systematic generator. CUDA has no
    int8 matrix product in ``torch.matmul``, so this is a float32 product
    of the 0/1 matrices, then ``& 1``: exact, because every sum is an
    integer ≤ k < 2^24. TF32 is switched off for the product all the same.
    """
    dev = u.device
    Gt = code.cached(
        ("encode_Gt", str(dev)),
        lambda: torch.from_numpy(code.G.T.copy()).to(dev, torch.float32),
    )
    inv_perm = code.cached(
        ("encode_inv_perm", str(dev)),
        lambda: torch.from_numpy(code.inv_perm).to(dev),
    )
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cp = torch.matmul(u.to(torch.float32), Gt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cp = (cp.to(torch.int32) & 1).to(torch.int8)
    return cp.index_select(1, inv_perm)
