"""The decode's operations and bytes a step, counted from the shapes, as
PERF.md section 6 ("How the bound is worked out") counts them.

Bytes: the channel LLRs read once (f32) and the hard bits written once
(int8) a codeword bit, and 4 B a codeword of iteration counts where the
decode stops early. f32 operations an edge and iteration of min-sum: 8
(the v2c subtract, |v|, the negative count, the two-minima update (2),
the exclusive-sign parity, the exclusive-minimum select and the sign
multiply), + 1 for flooding's posterior accumulate or + 2 for layered's
message difference and posterior update, + 2 where the iteration's beta
is not 0, + 1 where its alpha is not 1, + 2 with a clamp. Sum-product: 5
(the v2c subtract, the negative count, the sum accumulate, the
exclusive-sign parity, the sign multiply) + the same 1 or 2, + 147 f32
and 4 special-function operations of the transcendental sequence an edge,
frozen here from the SASS of the H100 build they were counted on (PERF.md
section 6), so that the yardstick does not move with the kernel. An
early-stopping decode counts the iterations each codeword ran and 2
operations an edge for each syndrome check (one on entry, one after each
iteration it ran).
"""

from __future__ import annotations

SP_F32_PER_EDGE = 147
SP_MUFU_PER_EDGE = 4
MS_BASE = {"flooding": 8 + 1, "layered": 8 + 2}
SP_BASE = {"flooding": 5 + 1, "layered": 5 + 2}
OPS_PER_EDGE_CHECK = 2


def edges(code: dict) -> int:
    return sum(s >= 0 for row in code["base"] for s in row) * code["z"]


def _table(v, iterations: int) -> list[float]:
    return list(v) if isinstance(v, list) else [v] * iterations


def work(code: dict, dec: dict, batch: int, iterations_run, method: str,
         schedule: str) -> dict:
    """Bytes, f32 and special-function operations of one decode of
    ``batch`` codewords; ``iterations_run`` is the iterations the batch's
    codewords ran in all where the decode stops early."""
    E, n, T = edges(code), code["n"], dec["iterations"]
    es = dec["early_stop"]
    if es and iterations_run is None:
        raise ValueError("an early-stopping decode needs the iterations run")
    if method == "min-sum":
        clamp = 2 if dec["clamp"] is not None else 0
        per_iter = [MS_BASE[schedule] + clamp + (a != 1.0) + 2 * (b != 0.0)
                    for a, b in zip(_table(dec["alpha"], T),
                                    _table(dec["beta"], T))]
        mufu = 0
    else:
        per_iter = [SP_BASE[schedule] + SP_F32_PER_EDGE] * T
        mufu = SP_MUFU_PER_EDGE
    if es:
        # a constant count an iteration: clamp and scalar alpha/beta
        ran = float(iterations_run)
        f32 = (ran * E * per_iter[0]
               + (batch + ran) * E * OPS_PER_EDGE_CHECK)
        sfu = ran * E * mufu
        nbytes = batch * (n * (4 + 1) + 4)
    else:
        f32 = batch * E * sum(per_iter)
        sfu = batch * E * mufu * T
        nbytes = batch * n * (4 + 1)
    return {"bytes": nbytes, "f32_ops": f32, "mufu_ops": sfu}
