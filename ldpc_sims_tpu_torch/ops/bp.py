"""Belief-propagation decode dispatch: the port of ``ops/bp.py:bp_decode``.

The port decodes quasi-cyclic codes with min-sum (scalar or
per-iteration α/β) or the stable log-domain sum-product under the
flooding, the layered (serial-C) and the group-serial layered schedule,
with an optional clamp, message quantization (``msg_qbits``/
``msg_qclip``), edge-flavor neural-BP weights and per-codeword early
stop in the JAX package's three modes (freeze, requeue, probe).
Backends:

* ``'cuda'``: the hand-written kernels of
  :mod:`ldpc_sims_tpu_torch.kernels.minsum_qc` and their drivers (on a
  CPU tensor the wrapper runs the plain version);
* ``'roll'``: the plain PyTorch version (:mod:`.bp_roll`) on any device;
  of early stop it takes ``es_mode='freeze'`` with a check every
  iteration, as the JAX roll backend does, and it takes no
  ``layered_group > 1``, as the JAX roll backend does not, and no
  message storage narrower than f32 (JAX's roll backend computes bf16 in
  bf16 arithmetic, another function, ROADMAP A4; int8 is kernel-only,
  as in JAX); gradients flow through it;
* ``'auto'``: ``'cuda'`` for a CUDA tensor, and for the forms only the
  kernels' module implements (requeue, probe, a check stride above 1,
  ``layered_group > 1``, bf16 or int8 storage); else ``'roll'`` for a
  CPU tensor. JAX's ``auto`` on the CPU sends bf16 to its roll backend
  and raises for int8 (ROADMAP §C).

What the JAX function does beyond that raises ``NotImplementedError``
naming its ROADMAP item; nothing falls back silently.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.convert import decoder_weights_from_numpy
from ldpc_sims_tpu_torch.ops.bp_roll import (
    EDGE_KEYS,
    decode_roll,
    pack_edge_weights,
    storage_dtype,
)

__all__ = [
    "bp_decode",
    "freeze_minsum_weights",
    "init_minsum_weights",
    "init_neural_bp_weights",
    "pack_decoder_weights",
]


def init_neural_bp_weights(code: LdpcCode, iterations: int,
                           flavor: str = "edge") -> dict[str, torch.Tensor]:
    """All-ones edge-flavor neural-BP weights (= plain BP), in JAX's
    layout: ``w_msg`` (iterations, n, dv) with check-sorted variable
    slots, ``w_llr`` (iterations, n), ``w_msg_final`` (n, dv) and
    ``w_llr_final`` (n,). The pair flavor needs the gather backend
    (ROADMAP A4)."""
    if flavor == "pair":
        raise NotImplementedError(
            "pair-flavor neural-BP weights need the gather backend, not "
            "ported yet (ROADMAP A4)")
    if flavor != "edge":
        raise ValueError(f"unknown flavor {flavor!r}")
    g = code.graph
    return {
        "w_llr": torch.ones((iterations, g.n_vars)),
        "w_msg_final": torch.ones((g.n_vars, g.dv)),
        "w_llr_final": torch.ones((g.n_vars,)),
        "w_msg": torch.ones((iterations, g.n_vars, g.dv)),
    }


def init_minsum_weights(iterations: int) -> dict[str, torch.Tensor]:
    """Identity weighted-min-sum weights: per-iteration ``ms_alpha``
    (ones) and ``ms_beta`` (zeros)."""
    return {"ms_alpha": torch.ones((iterations,)),
            "ms_beta": torch.zeros((iterations,))}


def _floats(v) -> tuple:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return tuple(float(x) for x in np.asarray(v))


def freeze_minsum_weights(weights: dict) -> tuple[tuple, tuple]:
    """Trained ms weights ``{'ms_alpha', 'ms_beta'}`` (arrays or tensors)
    → static ``(alpha, beta)`` tuples for ``bp_decode(alpha=, beta=)``."""
    return _floats(weights["ms_alpha"]), _floats(weights["ms_beta"])


def pack_decoder_weights(weights: dict | None, code: LdpcCode,
                         iterations: int, device) -> dict | None:
    """Decoder weights made ready once for many decodes on ``device``.

    ``ms_alpha``/``ms_beta`` are frozen to tuples of floats on the host
    (:func:`freeze_minsum_weights`), the kernels' cached α/β table. Every
    other array becomes a float32 tensor there
    (:func:`..convert.decoder_weights_from_numpy`), and a complete
    edge-flavor set is packed into the kernels' tables, which
    :func:`bp_decode` takes under the key ``'tables'`` in place of the
    four arrays. The sweep engine calls it once per sweep, so no step
    converts or packs the 163k weights of a 6-iteration wifi1944 decoder
    again.
    """
    if weights is None:
        return None
    weights = dict(weights)
    ms = {k: weights.pop(k) for k in ("ms_alpha", "ms_beta")
          if k in weights}
    out = decoder_weights_from_numpy(weights, device)
    out.update({k: _floats(v) for k, v in ms.items()})
    if EDGE_KEYS <= set(out) and code.qc is not None:
        edge = {k: out.pop(k) for k in EDGE_KEYS}
        out["tables"] = pack_edge_weights(edge, code.qc, iterations, device)
    return out


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
    threads: int | None = None,
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
      weights: optional decoder weights, JAX's dict (NumPy arrays or
        tensors; :func:`init_neural_bp_weights`,
        :func:`init_minsum_weights`, :func:`..utils.load_decoder_weights`)
        or :func:`pack_decoder_weights`'s. Edge-flavor arrays (``w_msg``,
        ``w_llr``, ``w_msg_final``, ``w_llr_final``) weight each edge per
        iteration, under either schedule, not with early stop; the
        ``cuda`` backend runs them in the ``_w`` kernels. ``ms_alpha``/
        ``ms_beta`` are a per-iteration α/β (min-sum; not with tuple
        α/β). JAX sends a dict holding ``ms_*`` to its roll backend,
        because traced arrays cannot be baked into its Pallas kernel; the
        port's kernels read α/β from a table at run time, so here such a
        dict runs the kernels on the card, with the ms arrays frozen to
        that table. Weights that need a gradient decode with
        ``backend='roll'``: the kernels carry none, and the ``cuda``
        path raises rather than drop it. The pair flavor (``w_pair``)
        needs the gather backend (ROADMAP A4).
      backend: 'auto' | 'cuda' | 'roll' (module docs).
      schedule: 'flooding' | 'layered'.
      layered_group: block rows per serial group of the layered schedule
        (1 = serial-C; ``mb`` = one flooding iteration up to the order of
        the sums); above 1 the kernels' module only, as in JAX.
      dtype: message storage, ``torch.float32``, ``torch.bfloat16``
        (messages, posterior and channel LLRs in bf16) or ``torch.int8``
        (messages on the 255-level grid over ±``msg_qclip``), or their
        names; the Pallas kernel's semantics
        (:func:`.bp_roll.decode_roll`), so bf16 and int8 take the
        kernels' module (``auto`` resolves to ``cuda``).
      threads: the flooding kernels' CTA size (JAX's ``tile``), a
        multiple of 32 in [32, 1024]; None takes the measured default
        (:func:`..kernels.minsum_qc.default_threads`). The ``roll``
        backend ignores it, as JAX's ignores ``tile``.

    ``method='sum-product-ref'`` and non-QC codes are not ported yet.
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
    # per-iteration α/β: static tuples, or the ms_alpha/ms_beta arrays of
    # a weight dict (JAX's ms pytree keys)
    ms_w = None
    if weights is not None and ("ms_alpha" in weights
                                or "ms_beta" in weights):
        weights = dict(weights)
        ms_w = {
            "alpha": weights.pop("ms_alpha", np.ones(iterations, np.float32)),
            "beta": weights.pop("ms_beta", np.zeros(iterations, np.float32)),
        }
        for nm in ("alpha", "beta"):
            shape = np.shape(ms_w[nm])
            if shape != (iterations,):
                raise ValueError(
                    f"ms_{nm} must have shape ({iterations},) to match "
                    f"iterations={iterations}, got {shape}"
                )
        if not weights:
            weights = None
        if isinstance(alpha, tuple) or isinstance(beta, tuple):
            raise ValueError(
                "pass tuple alpha/beta OR ms_alpha/ms_beta weights, not both"
            )
    if (
        isinstance(alpha, tuple) or isinstance(beta, tuple)
        or ms_w is not None
    ) and method != "min-sum":
        raise ValueError("per-iteration alpha/beta require method='min-sum'")
    for v, nm in ((alpha, "alpha"), (beta, "beta")):
        if isinstance(v, tuple) and len(v) != iterations:
            raise ValueError(
                f"per-iteration {nm} needs length {iterations}, got {len(v)}"
            )
    if weights is not None:
        if "w_pair" in weights:
            raise NotImplementedError(
                "pair-flavor neural-BP weights (w_pair) need the gather "
                "backend, not ported yet (ROADMAP A4)"
            )
        weights = weights.get("tables", weights)
    if not (isinstance(code, LdpcCode) and code.qc is not None):
        raise NotImplementedError(
            "non-QC codes need the dense/gather decode, not ported yet "
            "(ROADMAP A4)"
        )
    if backend in ("dense", "gather"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP A4)"
        )
    dtype = storage_dtype(dtype)
    # the forms only the kernels' module implements
    needs_cuda = layered_group != 1 or dtype != torch.float32 or (
        early_stop and (es_mode != "freeze" or es_check_every != 1))
    if backend == "auto":
        backend = ("cuda" if llr.device.type == "cuda" or needs_cuda
                   else "roll")
    if backend not in ("cuda", "roll"):
        raise ValueError(f"unknown backend {backend!r}")
    if layered_group != 1 and backend != "cuda":
        raise ValueError(
            "layered_group is cuda-only; pass backend='cuda' (on a CPU "
            "tensor it runs the plain version)"
        )
    if dtype == torch.int8 and backend != "cuda":
        raise ValueError(
            "int8 message storage is a kernel feature (messages live on a "
            "255-level grid over ±msg_qclip in shared memory); pass "
            "backend='cuda' (on a CPU tensor it runs the plain version)"
        )
    if dtype == torch.bfloat16 and backend == "roll":
        raise NotImplementedError(
            "bf16 on the roll backend is JAX's bf16-arithmetic decode, not "
            "ported yet (ROADMAP A4); backend='cuda' stores bf16 with the "
            "kernels' f32 arithmetic"
        )
    if early_stop and (es_mode != "freeze" or es_check_every != 1):
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
    llr = llr.to(torch.float32).contiguous()
    kw = dict(iterations=iterations, clamp=clamp, schedule=schedule,
              method=method, msg_qbits=msg_qbits, msg_qclip=msg_qclip,
              layered_group=layered_group, dtype=dtype)
    # without early stop the iteration count is the fixed budget
    fixed_iters = output == "hard_iters" and not early_stop
    kw["output"] = ("posterior" if output == "soft" else
                    "hard" if fixed_iters else output)
    if backend == "roll":
        out = decode_roll(llr, code.qc, alpha=alpha, beta=beta,
                          early_stop=early_stop, weights=weights,
                          ms_weights=ms_w, **kw)
    else:
        # imported here: the kernels' module imports this package's bp_roll
        from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

        if ms_w is not None:  # the kernels' α/β table
            if any(isinstance(v, torch.Tensor) and v.requires_grad
                   for v in ms_w.values()):
                raise NotImplementedError(
                    "the decode kernels carry no gradient: ms_alpha/ms_beta "
                    "that need one decode with backend='roll' (training "
                    "through the kernels is not ported, ROADMAP A10)")
            alpha, beta = _floats(ms_w["alpha"]), _floats(ms_w["beta"])
        kw.update(alpha=alpha, beta=beta, threads=threads)
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
                                es_check_every=es_check_every,
                                weights=weights, **kw)
    if output == "soft":
        return torch.sigmoid(0.5 * out)
    if fixed_iters:
        return out, torch.full((llr.shape[0],), iterations,
                               dtype=torch.int32, device=llr.device)
    return out

