"""Belief-propagation decode dispatch: the port of ``ops/bp.py:bp_decode``.

The port decodes with min-sum (scalar or per-iteration α/β), the stable
log-domain sum-product or the reference's tanh-product rule
(``sum-product-ref``), with an optional clamp, message quantization
(``msg_qbits``/``msg_qclip``), edge-flavor neural-BP weights and
per-codeword early stop. Backends:

* ``'cuda'``: the hand-written kernels of
  :mod:`ldpc_sims_tpu_torch.kernels.minsum_qc` and their drivers for a
  quasi-cyclic code (min-sum and sum-product; flooding, layered and
  group-serial layered; early stop in the JAX package's three modes,
  freeze, requeue and probe; f32, bf16 or int8 message storage with the
  Pallas kernel's semantics). On a CPU tensor the wrapper runs the plain
  version.
* ``'roll'``: the plain PyTorch QC decode (:mod:`.bp_roll`) on any
  device, the counterpart of JAX's roll backend: flooding and layered, of
  early stop ``es_mode='freeze'`` with a check every iteration, no
  ``layered_group > 1``, all three methods. ``dtype=torch.bfloat16``
  computes in bf16 arithmetic, as JAX's roll backend does
  (``ldpc_sims_tpu/ops/bp_roll.py:180``); int8 is kernel-only, as in JAX.
  Gradients flow through it.
* ``'gather'``: JAX's gather backend (``ldpc_sims_tpu/ops/bp.py:756-911``)
  for any code or bare :class:`TannerGraph`: flooding BP on the Tanner
  graph's padded slot layouts (``TannerGraph.to_var_space``/
  ``to_check_space``/``c_mask``/``v_mask``) with the batch first, all
  three methods, edge-flavor, pair-flavor (``w_pair``) and ``ms_*``
  weights, ``es_mode='freeze'``, f32 or bf16 arithmetic; no layered
  schedule, as in JAX. Plain PyTorch on any device: JAX decodes non-QC
  codes in plain XLA too, with no Pallas kernel.
* ``'dense'``: JAX's dense backend (``ldpc_sims_tpu/ops/bp.py:686-755``),
  the same flooding BP with the variable update as products with the
  graph's 0/1 routing matrices: one Ec×Ec product ``W_v``
  (``TannerGraph.dense_routing``) up to Ec = m·dc = 1024 padded edges,
  beyond it the factored ``L_exp @ (M_fin @ x + lv) − x``
  (``TannerGraph.factored_routing``), refused above n·Ec = 2^26; its
  early stop checks syndromes by a product with H. JAX asks for these
  products at ``Precision.HIGHEST`` or through ``_dot_split``, because a
  one-pass bf16 product shifts hard bits; the port computes each product
  exactly, in float64 (a 0/1 matrix times float32 values sums a few
  terms exactly there), and rounds it once to the message type. So TF32
  (``torch.backends.cuda.matmul``), which would round the operands,
  never touches it, and its result does not depend on the order in which
  the GEMM sums. Plain ``torch.matmul``, as JAX's are plain XLA products.
* ``'auto'``: every non-QC code goes to ``'gather'``, on the CPU and on
  the card. JAX's ``auto`` picks its dense backend up to m·dc ≤ 1024
  padded edges and routes around a TPU compiler crash beyond it
  (``ldpc_sims_tpu/ops/bp.py:538-554``); neither reason holds on a GPU,
  and dense and gather compute the same function up to the order of
  their sums (``backend='dense'`` asks for the dense one). Pair-flavor
  weights go to ``'gather'``, as in JAX. A QC code goes to ``'cuda'`` for
  a CUDA tensor and for the
  forms only the kernels' module implements (requeue, probe, a check
  stride above 1, ``layered_group > 1``), else to ``'roll'``; so on a CPU
  tensor bf16 decodes in bf16 arithmetic and int8 raises ``ValueError``,
  as JAX's CPU ``auto`` does, while on a CUDA tensor bf16 and int8 take
  the kernels' storage, as JAX's TPU ``auto`` takes the Pallas kernel's.
  ``sum-product-ref`` has no kernel: a QC code decodes it on ``'roll'``.
  No kernel carries a gradient either: while autograd records
  (``torch.is_grad_enabled()``) and the LLRs or a weight tensor require a
  gradient, a QC code decodes on ``'roll'`` and keeps the graph; an
  explicit ``'cuda'`` raises ``NotImplementedError``. JAX's ``auto`` keeps every soft or posterior
  output off its Pallas kernel (``ldpc_sims_tpu/ops/bp.py:353-366``); the
  port's keeps them on the kernels unless a gradient is needed (ROADMAP
  C10), so the trainers' decodes run the plain version and a trained
  decoder's hard-output decodes run the kernels.

A bare :class:`TannerGraph` has no QC structure, so it takes the non-QC
routes, as in JAX. :func:`syndrome`, :func:`syndrome_from_bits_nb` and
:func:`decode_to_bits` are JAX's helpers of the same names.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import LdpcCode
from ldpc_sims_tpu_torch.codes.tanner import TannerGraph
from ldpc_sims_tpu_torch.convert import decoder_weights_from_numpy
from ldpc_sims_tpu_torch.ops.bp_roll import (
    EDGE_KEYS,
    NO_GRADIENT,
    EdgeTables,
    _exclusive_sign,
    _exclusive_sum,
    _ref_excl,
    decode_roll,
    needs_gradient,
    pack_edge_weights,
    storage_dtype,
)

__all__ = [
    "bp_decode",
    "decode_to_bits",
    "freeze_minsum_weights",
    "init_minsum_weights",
    "init_neural_bp_weights",
    "pack_decoder_weights",
    "syndrome",
    "syndrome_from_bits_nb",
]

_DENSE_MAX_PADDED_EDGES = 1024  # beyond this the Ec×Ec product gets large
# the factored routing's cap on n·Ec elements a routing matrix (JAX's
# ldpc_sims_tpu/ops/bp.py:74)
_FACTORED_MAX_ELEMS = 1 << 26


def init_neural_bp_weights(graph: TannerGraph | LdpcCode, iterations: int,
                           flavor: str = "edge") -> dict[str, torch.Tensor]:
    """All-ones neural-BP weights (= plain BP), in JAX's layout.

    ``flavor='edge'``: ``w_msg`` (iterations, n, dv) with check-sorted
    variable slots, ``w_llr`` (iterations, n), ``w_msg_final`` (n, dv)
    and ``w_llr_final`` (n,). ``flavor='pair'`` adds ``w_pair``
    (iterations, n, dv, dv): entry [t, v, j, i] scales incoming slot i's
    message inside outgoing slot j's exclusive sum (the diagonal is
    ignored); the gather backend's, as in JAX."""
    if flavor not in ("edge", "pair"):
        raise ValueError(f"unknown flavor {flavor!r}")
    g = graph.graph if isinstance(graph, LdpcCode) else graph
    w = {
        "w_llr": torch.ones((iterations, g.n_vars)),
        "w_msg_final": torch.ones((g.n_vars, g.dv)),
        "w_llr_final": torch.ones((g.n_vars,)),
        "w_msg": torch.ones((iterations, g.n_vars, g.dv)),
    }
    if flavor == "pair":
        w["w_pair"] = torch.ones((iterations, g.n_vars, g.dv, g.dv))
    return w


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
    four arrays (not with ``w_pair``, which decodes on the gather
    backend). The sweep engine calls it once per sweep, so no step
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
    if EDGE_KEYS <= set(out) and "w_pair" not in out and code.qc is not None:
        edge = {k: out.pop(k) for k in EDGE_KEYS}
        out["tables"] = pack_edge_weights(edge, code.qc, iterations, device)
    return out


_BIG = 1e30  # inert magnitude of a padding slot


def _take(x: torch.Tensor, idx: torch.Tensor, fill: float) -> torch.Tensor:
    """``x[..., idx]`` with the index one past the end giving ``fill``
    (JAX's ``_take0`` with mode='fill')."""
    pad = torch.full_like(x[..., :1], fill)
    return torch.cat([x, pad], -1).index_select(-1, idx)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def _checks_parity(bits: torch.Tensor, g: TannerGraph) -> torch.Tensor:
    """(B, n) bits → (B, m) int32 parity of each check, by the gather of
    :func:`syndrome_from_bits_nb` with the batch first."""
    to_check = _index(g.to_check_space, bits.device)
    cs = _take(bits.to(torch.int32).repeat_interleave(g.dv, -1), to_check, 0)
    return cs.reshape(bits.shape[0], g.n_checks, g.dc).sum(
        -1, dtype=torch.int32) & 1


def syndrome_from_bits_nb(bits_nb: torch.Tensor,
                          g: TannerGraph) -> torch.Tensor:
    """Syndrome from bits in JAX's (n, B) layout → (m, B) int32 parity of
    each check: each variable's bit repeated over its dv slots, gathered
    into check space and summed (JAX ``ops/bp.py:912-925``)."""
    return _checks_parity(bits_nb.T, g).T


def _parity_product(bits: torch.Tensor, Ht: torch.Tensor) -> torch.Tensor:
    """(B, n) 0/1 bits times the (n, m) float32 Hᵀ, & 1. A product of 0s
    and 1s is exact in float32 and in TF32, and float32 sums integers
    below 2^24 exactly in any order, so the parity is exact for rows of
    fewer than 2^24 ones (torch has no integer matmul on CUDA)."""
    return (bits.to(torch.float32) @ Ht).to(torch.int32) & 1


def syndrome(bits: torch.Tensor, H: np.ndarray) -> torch.Tensor:
    """(B, n) hard bits → (B, m) int32 syndrome, JAX's ``bits @ Hᵀ & 1``
    (``ops/bp.py:928-937``), on the bits' device."""
    Ht = torch.as_tensor(np.asarray(H).T, dtype=torch.float32,
                         device=bits.device)
    return _parity_product(bits, Ht)


def _decode_graph(llr: torch.Tensor, g: TannerGraph, *, backend: str,
                  iterations: int, method: str, alpha, beta, ms_w, clamp,
                  msg_qbits, msg_qclip, weights, early_stop: bool,
                  output: str, dtype) -> torch.Tensor:
    """JAX's dense and gather backends (``ldpc_sims_tpu/ops/bp.py:
    686-911``) with the batch first: flooding BP with messages (B, m, dc)
    in check space.

    ``'gather'``: a variable update gathers the messages into variable
    space (B, n, dv), sums them with the (weighted) LLR and gathers the
    exclusive sums back; ``sum-product-ref`` takes its exclusive sum from
    prefix and suffix sums, pair weights (``w_pair``) their exclusive
    weighted mix. ``'dense'``: the variable update as exact products with
    the 0/1 routing matrices (module docs), the edge weights moved once
    from variable-space slots to check space (JAX's ``w_to_cs``), early
    stop by the product with H. Every other operation runs in ``dtype``
    (f32 or bf16), as in JAX. ``output``: 'hard', 'posterior' (log
    Pr1/Pr0), 'hard_iters'; early stop freezes each codeword at its first
    syndrome-satisfying state."""
    n, m, dc, dv = g.n_vars, g.n_checks, g.dc, g.dv
    B = llr.shape[0]
    Ec = m * dc
    dev = llr.device
    c_mask = torch.from_numpy(np.asarray(g.c_mask, bool)).to(dev)
    Lv = (-llr).to(dtype)  # internal log(Pr0/Pr1)
    ref_mode = method == "sum-product-ref"
    if weights is not None:
        weights = {k: torch.as_tensor(v, device=dev).to(dtype)
                   for k, v in weights.items()}

    if backend == "dense":
        # small codes: one Ec×Ec product (W_v); beyond Ec = 1024 the exact
        # factorization W_v = L_exp @ M_fin − I on valid slots, two
        # rectangular products with O(n·Ec) constants
        factored = Ec > _DENSE_MAX_PADDED_EDGES
        if factored and n * Ec > _FACTORED_MAX_ELEMS:
            raise ValueError(
                f"code too large for factored dense routing (n·Ec = "
                f"{n * Ec} > {_FACTORED_MAX_ELEMS}); decode with "
                "backend='gather'")
        routing = g.factored_routing if factored else g.dense_routing
        # float64 constants: every routing product below is exact
        L_exp = torch.from_numpy(routing["L_exp"]).to(dev).double()  # Ec×n
        W_v = (None if factored
               else torch.from_numpy(routing["W_v"]).to(dev).double())
        H = np.zeros((m, n), np.float32)
        H[g.edge_check, g.edge_var] = 1.0
        Ht = torch.from_numpy(H.T.copy()).to(dev)

        def route(x, A):
            """``x @ A`` exactly, rounded once to ``dtype``."""
            return (x.double() @ A).to(dtype)

        # variable-space weight slots → check-space edge order, once
        vslot = _index(np.minimum(g.to_check_space, n * dv - 1), dev)
        cs_valid = torch.from_numpy(g.to_check_space < n * dv).to(dev)

        def w_to_cs(w):
            flat = w.reshape(*w.shape[:-2], n * dv).index_select(-1, vslot)
            return torch.where(cs_valid, flat, 0.0)

        if weights is not None:
            w_msg_cs = w_to_cs(weights["w_msg"])
            w_fin_cs = w_to_cs(weights["w_msg_final"])

        def var_to_check(c2v, it):
            x = c2v.reshape(B, Ec)
            lv = Lv
            if weights is not None:
                x = w_msg_cs[it] * x
                lv = weights["w_llr"][it] * Lv
            if factored:
                tot = route(x, L_exp) + lv
                v2c = route(tot, L_exp.T) - x
            else:
                v2c = route(x, W_v) + route(lv, L_exp.T)  # W_v symmetric
            return torch.where(c_mask, v2c.reshape(B, m, dc), _BIG)

        def posterior(c2v):
            x = c2v.reshape(B, Ec)
            lv = Lv
            if weights is not None:
                x = w_fin_cs * x
                lv = weights["w_llr_final"] * Lv
            return lv + route(x, L_exp)

        def satisfied(c2v):
            """(B,) bool: the hard decisions satisfy every check."""
            bits = posterior(c2v) < 0
            return (_parity_product(bits, Ht) == 0).all(-1)

    else:
        to_var = _index(g.to_var_space, dev)
        to_check = _index(g.to_check_space, dev)
        v_mask = torch.from_numpy(np.asarray(g.v_mask, bool)).to(dev)
        pair = weights is not None and "w_pair" in weights
        if pair:  # slot j's own message stays out of its mix (the diagonal)
            offdiag = (1.0 - torch.eye(dv, device=dev)).to(dtype)

        def to_var_space(c2v):
            return _take(c2v.reshape(B, Ec), to_var, 0.0).reshape(B, n, dv)

        def var_to_check(c2v, it):
            vm = to_var_space(c2v)
            lv = Lv
            if weights is not None:
                vm = vm * weights["w_msg"][it]
                lv = weights["w_llr"][it] * Lv
            vm = torch.where(v_mask, vm, 0.0)
            if pair:
                wp = weights["w_pair"][it] * offdiag  # (n, dv out, dv in)
                v2c_v = lv[..., None] + torch.einsum("vji,bvi->bvj", wp, vm)
            elif ref_mode:
                v2c_v = lv[..., None] + _exclusive_sum(vm, -1)
            else:
                v2c_v = (lv + vm.sum(-1))[..., None] - vm
            return _take(v2c_v.reshape(B, n * dv), to_check,
                         _BIG).reshape(B, m, dc)

        def posterior(c2v):
            vm = to_var_space(c2v)
            lv = Lv
            if weights is not None:
                vm = vm * weights["w_msg_final"]
                lv = weights["w_llr_final"] * Lv
            return lv + torch.where(v_mask, vm, 0.0).sum(-1)

        def satisfied(c2v):
            """(B,) bool: the hard decisions satisfy every check."""
            return (_checks_parity(posterior(c2v) < 0, g) == 0).all(-1)

    def per_iteration(v):
        if isinstance(v, torch.Tensor) or isinstance(v, (tuple, np.ndarray)):
            return torch.as_tensor(v, device=dev).to(dtype)
        return None

    ms_a = per_iteration(alpha if ms_w is None else ms_w["alpha"])
    ms_b = per_iteration(beta if ms_w is None else ms_w["beta"])
    qstep = None
    if msg_qbits is not None:
        qstep = torch.tensor(2.0 * msg_qclip / (2**msg_qbits - 1),
                             device=dev).to(dtype)

    def check_update(v2c, it):
        if method == "min-sum":
            a = alpha if ms_a is None else ms_a[it]
            b = beta if ms_b is None else ms_b[it]
            mag = v2c.abs()
            min1, idx = mag.min(-1, keepdim=True)  # the first minimum
            if needs_gradient(mag):  # JAX's even split over tied minima
                min1 = mag.amin(-1, keepdim=True)
            first = torch.arange(dc, device=dev) == idx
            min2 = torch.where(first, _BIG, mag).amin(-1, keepdim=True)
            exmin = torch.where(first, min2, min1)
            y = (_exclusive_sign(v2c, -1) * torch.clamp_min(exmin - b, 0.0)
                 * a)
        elif method == "sum-product":
            mag = torch.clamp_min(v2c.abs(), 1e-12)
            lt = torch.log(-torch.expm1(-mag)) - torch.log1p(torch.exp(-mag))
            s = torch.clamp_max(_exclusive_sum(lt, -1), -1e-12)
            y = _exclusive_sign(v2c, -1) * (torch.log1p(torch.exp(s))
                                            - torch.log(-torch.expm1(s)))
        else:  # padding slots take the product's identity
            t = torch.where(c_mask, torch.tanh(v2c * 0.5), 1.0)
            y = _ref_excl(t.movedim(-1, 0)).movedim(0, -1)
        if clamp is not None:
            y = torch.clamp(y, -clamp, clamp)
        if qstep is not None:
            y = torch.clamp(torch.round(y / qstep) * qstep, -msg_qclip,
                            msg_qclip)
        return y

    c2v = torch.zeros((B, m, dc), dtype=dtype, device=dev)
    iters = torch.full((B,), iterations, dtype=torch.int32, device=dev)
    if early_stop:
        done = satisfied(c2v)
        iters[done] = 0
        for it in range(iterations):
            if bool(done.all()):
                break
            new = check_update(var_to_check(c2v, it), it)
            c2v = torch.where(done[:, None, None], c2v, new)
            newly = satisfied(c2v) & ~done
            iters[newly] = it + 1
            done = done | newly
    else:
        for it in range(iterations):
            c2v = check_update(var_to_check(c2v, it), it)
    post = posterior(c2v)
    if output == "posterior":
        return -post
    bits = (post < 0).to(torch.int8)
    return (bits, iters) if output == "hard_iters" else bits


def bp_decode(
    llr: torch.Tensor,
    code: LdpcCode | TannerGraph,
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
      code: an :class:`LdpcCode` (a QC one takes the roll and cuda
        backends) or a bare :class:`TannerGraph` (the dense and gather
        backends).
      iterations: BP iterations (fixed trip count).
      method: 'min-sum', 'sum-product' (stable log domain, the JAX roll
        backend's expm1/log1p form) or 'sum-product-ref' (the reference's
        tanh-product rule with the ±(1 − 1e-7) product clip; roll and
        gather backends).
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
        that table. Weights (or LLRs) that need a gradient decode on
        ``'roll'`` under ``auto``: the kernels carry none, and the
        ``cuda`` path raises rather than drop it. The dense and gather
        backends take the edge-flavor and ``ms_*`` arrays; the pair flavor
        (``w_pair``, :func:`init_neural_bp_weights`) decodes on the
        gather backend only: ``auto`` goes there, any other backend
        raises ``ValueError``, as in JAX.
      backend: 'auto' | 'cuda' | 'roll' | 'dense' | 'gather' (module
        docs).
      schedule: 'flooding' | 'layered' (QC codes on the roll and cuda
        backends).
      layered_group: block rows per serial group of the layered schedule
        (1 = serial-C; ``mb`` = one flooding iteration up to the order of
        the sums); above 1 the kernels' module only, as in JAX.
      dtype: ``torch.float32``, ``torch.bfloat16`` or ``torch.int8``, or
        their names. On the ``cuda`` backend the message storage of the
        Pallas kernel (:func:`.bp_roll.decode_roll`): bf16 messages,
        posterior and channel LLRs, or int8 messages on the 255-level
        grid over ±``msg_qclip``, with f32 arithmetic. On the ``roll``,
        ``dense`` and ``gather`` backends the arithmetic, as in JAX: bf16
        computes every operation in bf16 (the dense routing products
        exactly, then rounded to bf16); int8 raises ``ValueError``.
      threads: the flooding kernels' CTA size (JAX's ``tile``), a
        multiple of 32 in [32, 1024]; None takes the measured default
        (:func:`..kernels.minsum_qc.default_threads`). The ``roll``
        backend ignores it, as JAX's ignores ``tile``.

    A non-QC code or a bare graph decodes on the gather backend under
    ``auto`` (module docs).
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
        if "w_pair" in weights and backend != "gather":
            if backend != "auto":
                raise ValueError("pair-flavor weights need backend='gather'")
            backend = "gather"
        weights = weights.get("tables", weights)
    if isinstance(code, LdpcCode):
        qc, g = code.qc, code.graph
    elif isinstance(code, TannerGraph):
        qc, g = None, code
    else:
        raise TypeError("code must be an LdpcCode or a TannerGraph, got "
                        f"{type(code).__name__}")
    if schedule == "layered" and (qc is None
                                  or backend in ("dense", "gather")):
        raise ValueError(
            "layered schedule requires a quasi-cyclic LdpcCode (roll or "
            "cuda backend)"
        )
    dtype = storage_dtype(dtype)
    # the forms only the kernels' module implements
    needs_cuda = layered_group != 1 or (
        early_stop and (es_mode != "freeze" or es_check_every != 1))
    on_card = llr.device.type == "cuda"
    # an input autograd must differentiate: the kernels carry no gradient
    grad_tensors = [] if weights is None else list(
        weights if isinstance(weights, EdgeTables) else weights.values())
    if ms_w is not None:
        grad_tensors += ms_w.values()
    needs_grad = needs_gradient(llr, *grad_tensors)
    if backend == "auto":
        if qc is None:
            backend = "gather"
        elif method == "sum-product-ref" or needs_grad:
            # no kernel has the reference's rule or a gradient
            backend = "roll"
        else:
            backend = ("cuda" if on_card or needs_cuda else "roll")
    if backend not in ("cuda", "roll", "dense", "gather"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("cuda", "roll") and qc is None:
        raise ValueError(f"the {backend} backend requires a quasi-cyclic "
                         "LdpcCode")
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
    if method == "sum-product-ref" and backend == "cuda":
        raise ValueError(
            "method='sum-product-ref' has no kernel; it decodes on the roll "
            "or gather backend"
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

    llr = llr.to(torch.float32).contiguous()
    # without early stop the iteration count is the fixed budget
    fixed_iters = output == "hard_iters" and not early_stop
    out_kind = ("posterior" if output == "soft" else
                "hard" if fixed_iters else output)
    kw = dict(iterations=iterations, clamp=clamp, schedule=schedule,
              method=method, msg_qbits=msg_qbits, msg_qclip=msg_qclip,
              layered_group=layered_group, dtype=dtype, output=out_kind)
    if backend in ("dense", "gather"):
        if isinstance(weights, EdgeTables):
            raise ValueError(f"the {backend} backend takes JAX's weight "
                             "dict, not the kernels' packed tables")
        out = _decode_graph(
            llr, g, backend=backend, iterations=iterations, method=method,
            alpha=alpha, beta=beta, ms_w=ms_w, clamp=clamp,
            msg_qbits=msg_qbits, msg_qclip=msg_qclip, weights=weights,
            early_stop=early_stop, output=out_kind, dtype=dtype)
    elif backend == "roll":
        # JAX's roll backend computes a bf16 decode in bf16 arithmetic
        kw.update(dtype=torch.float32, arith=dtype)
        out = decode_roll(llr, qc, alpha=alpha, beta=beta,
                          early_stop=early_stop, weights=weights,
                          ms_weights=ms_w, **kw)
    else:
        # imported here: the kernels' module imports this package's bp_roll
        from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

        if needs_grad:
            raise NotImplementedError(NO_GRADIENT)
        if ms_w is not None:  # the kernels' α/β table
            alpha, beta = _floats(ms_w["alpha"]), _floats(ms_w["beta"])
        kw.update(alpha=alpha, beta=beta, threads=threads)
        if early_stop and es_mode == "probe":
            out = mq.bp_qc_probe_requeue(
                llr, qc, probe_iters=es_probe_iters,
                probe_alpha=es_probe_alpha, probe_beta=es_probe_beta, **kw)
        elif early_stop and es_mode == "requeue":
            out = mq.bp_qc_requeue(
                llr, qc, probe_iters=es_probe_iters,
                es_check_every=es_check_every, **kw)
        else:
            out = mq.bp_qc_cuda(llr, qc, early_stop=early_stop,
                                es_check_every=es_check_every,
                                weights=weights, **kw)
    if output == "soft":
        return torch.sigmoid(0.5 * out)
    if fixed_iters:
        return out, torch.full((llr.shape[0],), iterations,
                               dtype=torch.int32, device=llr.device)
    return out



def decode_to_bits(llrs: torch.Tensor, code: LdpcCode | TannerGraph,
                   bp_iterations: int, clamp_value: float = 20.0,
                   method: str = "sum-product-ref") -> torch.Tensor:
    """The reference's ``decode_bits`` (``ofdm/ofdm_functions.py:131-163``)
    as JAX's ``decode_to_bits``: (batch, n) LLRs → int8 hard bits of one
    :func:`bp_decode` call."""
    return bp_decode(llrs, code, iterations=bp_iterations, method=method,
                     clamp=clamp_value, output="hard")
