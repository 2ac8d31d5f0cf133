"""Belief-propagation decode dispatch: the port of ``ops/bp.py:bp_decode``.

The port decodes quasi-cyclic codes with min-sum under the flooding and
the layered (serial-C) schedule, with scalar or per-iteration α/β and an
optional clamp. Backends:

* ``'cuda'``: the hand-written kernels of
  :mod:`ldpc_sims_tpu_torch.kernels.minsum_qc` (on a CPU tensor their
  wrapper runs the plain version);
* ``'roll'``: the plain PyTorch version (:mod:`.bp_roll`) on any device;
* ``'auto'``: ``'cuda'`` for a CUDA tensor, ``'roll'`` for a CPU tensor.

What the JAX function does beyond that raises ``NotImplementedError``
naming its ROADMAP item; nothing falls back silently.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll

__all__ = ["bp_decode", "freeze_minsum_weights"]


def freeze_minsum_weights(weights: dict) -> tuple[tuple, tuple]:
    """Trained ms weights ``{'ms_alpha', 'ms_beta'}`` (arrays or tensors)
    → static ``(alpha, beta)`` tuples for ``bp_decode(alpha=, beta=)``."""

    def floats(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return tuple(float(x) for x in np.asarray(v))

    return floats(weights["ms_alpha"]), floats(weights["ms_beta"])


def bp_decode(
    llr: torch.Tensor,
    code: LdpcCode,
    *,
    iterations: int = 20,
    method: str = "min-sum",
    alpha=1.0,
    beta=0.0,
    clamp: float | None = None,
    early_stop: bool = False,
    es_mode: str = "freeze",
    msg_qbits: int | None = None,
    weights=None,
    output: str = "hard",
    backend: str = "auto",
    schedule: str = "flooding",
    layered_group: int = 1,
    dtype=torch.float32,
) -> torch.Tensor:
    """Decode a batch of codewords with min-sum BP.

    Args:
      llr: (batch, n) channel LLRs, convention log(Pr1/Pr0).
      code: a quasi-cyclic :class:`LdpcCode`.
      iterations: BP iterations (fixed trip count).
      alpha, beta: normalization / offset for min-sum, scalars or
        length-``iterations`` tuples (a frozen per-iteration schedule,
        :func:`freeze_minsum_weights`).
      clamp: per-iteration c2v message clamp; None = no clamp.
      output: 'hard' → (batch, n) int8 bits; 'posterior' → (batch, n)
        f32 posterior log(Pr1/Pr0); 'soft' → Pr(bit=1) as the sigmoid of
        half the posterior.
      backend: 'auto' | 'cuda' | 'roll' (module docs).
      schedule: 'flooding' | 'layered'.

    ``early_stop``, ``msg_qbits``, ``weights``, ``layered_group > 1``,
    other methods, other dtypes and non-QC codes are not ported yet.
    """
    if method not in ("min-sum", "sum-product", "sum-product-ref"):
        raise ValueError(f"unknown method {method!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if es_mode not in ("freeze", "requeue", "probe"):
        hint = (
            " (es_mode='auto' is a sweep-engine dispatch; the decoder "
            "itself only takes concrete modes)" if es_mode == "auto" else ""
        )
        raise ValueError(f"unknown es_mode {es_mode!r}{hint}")
    if output not in ("hard", "posterior", "soft", "hard_iters"):
        raise ValueError(f"unknown output {output!r}")
    if isinstance(alpha, list):
        alpha = tuple(alpha)
    if isinstance(beta, list):
        beta = tuple(beta)
    for v, nm in ((alpha, "alpha"), (beta, "beta")):
        if isinstance(v, tuple) and len(v) != iterations:
            raise ValueError(
                f"per-iteration {nm} needs length {iterations}, got {len(v)}"
            )
    if layered_group != 1:
        raise NotImplementedError(
            "layered_group > 1 is not ported yet (ROADMAP B9)"
        )
    if not (isinstance(code, LdpcCode) and code.qc is not None):
        raise NotImplementedError(
            "non-QC codes need the dense/gather decode, not ported yet "
            "(ROADMAP A4)"
        )
    if backend in ("dense", "gather"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP A4)"
        )
    if backend == "auto":
        backend = "cuda" if llr.device.type == "cuda" else "roll"
    if backend not in ("cuda", "roll"):
        raise ValueError(f"unknown backend {backend!r}")

    if method != "min-sum":
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP A4 and B5); "
            "the port decodes min-sum only"
        )
    if early_stop:
        raise NotImplementedError(
            "early_stop is not ported yet (ROADMAP B3, B4 and B6)"
        )
    if msg_qbits is not None:
        raise NotImplementedError(
            "msg_qbits message quantization is not ported yet (ROADMAP B8)"
        )
    if weights is not None:
        raise NotImplementedError(
            "decoder weights are not ported yet (ROADMAP A10 and B7)"
        )
    if dtype != torch.float32:
        raise NotImplementedError(
            f"message storage dtype {dtype} is not ported yet (ROADMAP B10)"
        )
    if output == "hard_iters":
        raise NotImplementedError(
            "output='hard_iters' needs early stop (ROADMAP B6)"
        )
    llr = llr.to(torch.float32).contiguous()
    kw = dict(iterations=iterations, alpha=alpha, beta=beta, clamp=clamp,
              schedule=schedule,
              output="posterior" if output == "soft" else output)
    if backend == "roll":
        out = decode_roll(llr, code.qc, **kw)
    else:
        # imported here: the kernels' module imports this package's bp_roll
        from ldpc_sims_tpu_torch.kernels.minsum_qc import bp_qc_cuda

        out = bp_qc_cuda(llr, code.qc, **kw)
    if output == "soft":
        return torch.sigmoid(0.5 * out)
    return out
