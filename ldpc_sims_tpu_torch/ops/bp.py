"""Belief-propagation decode dispatch: the port of ``ops/bp.py:bp_decode``.

The port decodes quasi-cyclic codes with min-sum (scalar or
per-iteration α/β) or the stable log-domain sum-product under the
flooding and the layered (serial-C) schedule, with an optional clamp,
message quantization (``msg_qbits``/``msg_qclip``) and per-codeword early
stop in the JAX package's three modes (freeze, requeue, probe). Backends:

* ``'cuda'``: the hand-written kernels of
  :mod:`ldpc_sims_tpu_torch.kernels.minsum_qc` and their drivers (on a
  CPU tensor the wrapper runs the plain version);
* ``'roll'``: the plain PyTorch version (:mod:`.bp_roll`) on any device;
  of early stop it takes ``es_mode='freeze'`` with a check every
  iteration, as the JAX roll backend does;
* ``'auto'``: ``'cuda'`` for a CUDA tensor, and for the early-stop forms
  only the kernels' module implements (requeue, probe, a check stride
  above 1); else ``'roll'`` for a CPU tensor.

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
    es_check_every: int = 1,
    es_probe_iters: int = 4,
    es_probe_alpha=None,
    es_probe_beta=None,
    msg_qbits: int | None = None,
    msg_qclip: float = 20.0,
    weights=None,
    output: str = "hard",
    backend: str = "auto",
    schedule: str = "flooding",
    layered_group: int = 1,
    dtype=torch.float32,
) -> torch.Tensor:
    """Decode a batch of codewords with BP.

    Args:
      llr: (batch, n) channel LLRs, convention log(Pr1/Pr0).
      code: a quasi-cyclic :class:`LdpcCode`.
      iterations: BP iterations (fixed trip count).
      method: 'min-sum' or 'sum-product' (stable log domain, the JAX
        roll backend's expm1/log1p form).
      alpha, beta: normalization / offset for min-sum, scalars or
        length-``iterations`` tuples (a frozen per-iteration schedule,
        :func:`freeze_minsum_weights`).
      clamp: per-iteration c2v message clamp; None = no clamp.
      msg_qbits, msg_qclip: optional uniform quantization of each c2v
        message after the clamp: ``2**msg_qbits − 1`` levels over
        ±``msg_qclip`` (the quantized-decoder study).
      early_stop: per-codeword syndrome termination; each codeword
        freezes at its first syndrome-satisfying state.
      es_mode: 'freeze' (the semantics above), 'requeue' (an early-stop
        probe of ``es_probe_iters``, then a full-budget early-stop pass
        over the codewords it did not finish) or 'probe' (a fixed probe
        of ``es_probe_iters`` with the probe schedule ``es_probe_alpha``/
        ``es_probe_beta``, then a fixed full-budget pass over the
        codewords whose syndrome fails); the kernels' module only.
      es_check_every: check syndromes every K iterations (K must divide
        ``iterations``; above 1 the kernels' module only).
      output: 'hard' → (batch, n) int8 bits; 'posterior' → (batch, n)
        f32 posterior log(Pr1/Pr0); 'soft' → Pr(bit=1) as the sigmoid of
        half the posterior; 'hard_iters' → (bits, (batch,) int32
        iterations run, constant ``iterations`` without early stop).
      backend: 'auto' | 'cuda' | 'roll' (module docs).
      schedule: 'flooding' | 'layered'.

    ``weights``, ``layered_group > 1``, ``method='sum-product-ref'``,
    other dtypes and non-QC codes are not ported yet.
    """
    if method not in ("min-sum", "sum-product", "sum-product-ref"):
        raise ValueError(f"unknown method {method!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if early_stop and weights is not None:
        raise ValueError("early_stop with neural-BP weights is unsupported")
    if es_mode not in ("freeze", "requeue", "probe"):
        hint = (
            " (es_mode='auto' is a sweep-engine dispatch: run_sweep times "
            "the fixed decode against the probe decode per SNR point; the "
            "decoder itself only takes concrete modes)"
            if es_mode == "auto" else ""
        )
        raise ValueError(f"unknown es_mode {es_mode!r}{hint}")
    if output not in ("hard", "posterior", "soft", "hard_iters"):
        raise ValueError(f"unknown output {output!r}")
    if isinstance(alpha, list):
        alpha = tuple(alpha)
    if isinstance(beta, list):
        beta = tuple(beta)
    if isinstance(es_probe_alpha, list):
        es_probe_alpha = tuple(es_probe_alpha)
    if isinstance(es_probe_beta, list):
        es_probe_beta = tuple(es_probe_beta)
    if (isinstance(alpha, tuple) or isinstance(beta, tuple)) and (
        method != "min-sum"
    ):
        raise ValueError("per-iteration alpha/beta require method='min-sum'")
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
    # the early-stop forms only the kernels' module implements
    needs_cuda = early_stop and (es_mode != "freeze" or es_check_every != 1)
    if backend == "auto":
        backend = ("cuda" if llr.device.type == "cuda" or needs_cuda
                   else "roll")
    if backend not in ("cuda", "roll"):
        raise ValueError(f"unknown backend {backend!r}")
    if needs_cuda:
        if backend != "cuda":
            raise ValueError(
                "es_mode='requeue'/'probe' and es_check_every>1 are "
                f"cuda-only (resolved backend: {backend!r}); pass "
                "backend='cuda' (on a CPU tensor it runs the plain version)"
            )
        if es_mode in ("requeue", "probe") and output not in (
            "hard", "hard_iters"
        ):
            raise ValueError(
                f"es_mode={es_mode!r} supports output='hard'/'hard_iters'"
                " only"
            )
        if es_mode == "probe" and es_check_every != 1:
            raise ValueError(
                "es_check_every has no effect under es_mode='probe' "
                "(syndromes are checked once, after the probe); leave it "
                "at 1"
            )

    if method == "sum-product-ref":
        raise NotImplementedError(
            "method='sum-product-ref' (the reference's tanh-product rule) "
            "is not ported yet (ROADMAP A4)"
        )
    if weights is not None:
        raise NotImplementedError(
            "decoder weights are not ported yet (ROADMAP A10 and B7)"
        )
    if dtype != torch.float32:
        raise NotImplementedError(
            f"message storage dtype {dtype} is not ported yet (ROADMAP B10)"
        )
    llr = llr.to(torch.float32).contiguous()
    kw = dict(iterations=iterations, alpha=alpha, beta=beta, clamp=clamp,
              schedule=schedule, method=method, msg_qbits=msg_qbits,
              msg_qclip=msg_qclip)
    if output == "hard_iters" and not early_stop:
        bits = bp_decode(llr, code, backend=backend, **kw)
        return bits, torch.full((llr.shape[0],), iterations,
                                dtype=torch.int32, device=llr.device)
    kw["output"] = "posterior" if output == "soft" else output
    if backend == "roll":
        out = decode_roll(llr, code.qc, early_stop=early_stop, **kw)
    else:
        # imported here: the kernels' module imports this package's bp_roll
        from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

        if early_stop and es_mode == "probe":
            out = mq.bp_qc_probe_requeue(
                llr, code.qc, probe_iters=es_probe_iters,
                probe_alpha=es_probe_alpha, probe_beta=es_probe_beta, **kw)
        elif early_stop and es_mode == "requeue":
            out = mq.bp_qc_requeue(
                llr, code.qc, probe_iters=es_probe_iters,
                es_check_every=es_check_every, **kw)
        else:
            out = mq.bp_qc_cuda(llr, code.qc, early_stop=early_stop,
                                es_check_every=es_check_every, **kw)
    if output == "soft":
        return torch.sigmoid(0.5 * out)
    return out
