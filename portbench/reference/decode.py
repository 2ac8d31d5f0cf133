"""Belief-propagation decoding over the edges of H, in plain PyTorch.

Messages live on the edges in the convention L = log(Pr0/Pr1) (a bit is
1 where its posterior is negative), float32. A check's output on an edge
comes from the other edges' variable-to-check messages:

- min-sum: the product of their signs (a strict ``< 0`` test) times
  ``alpha_t * max(min |v| - beta_t, 0)``, iteration t's pair;
- sum-product: ``phi(sum phi(|v|))`` with ``phi(x) = log((1 + e^-x) /
  (1 - e^-x))``, the magnitudes floored at 1e-12 on the way in and the
  sum floored at 1e-12 on the way out, the sum taken over the slots in
  ascending variable order;

then clamped to +-clamp where a clamp is set. Flooding forms every
variable-to-check message from the posterior, the channel value plus the
check messages in ascending check order; layered (serial-C) visits the
block rows in order, and each row adds its messages' change to the
running posterior. Early stop freezes each codeword at its first state
whose hard decisions satisfy every check: on entry, then after each
iteration. ``storage='bfloat16'`` rounds the channel values, the
messages and the posteriors to bfloat16 as they are stored (the control).
"""

from __future__ import annotations

import torch

BIG = float("inf")
SP_FLOOR = 1e-12


def store(storage: str):
    """The rounding of a float32 tensor to ``storage`` and back."""
    if storage == "float32":
        return lambda v: v
    if storage == "bfloat16":
        def bf16(v):
            if v.is_complex():
                return torch.complex(bf16(v.real), bf16(v.imag))
            return v.to(torch.bfloat16).to(v.dtype)
        return bf16
    raise ValueError(f"unknown storage {storage!r}")


def _phi(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-x)) - torch.log(-torch.expm1(-x))


class Decoder:
    def __init__(self, code, device, method: str, schedule: str,
                 iterations: int, alpha=1.0, beta=0.0, clamp=None,
                 early_stop: bool = False, storage: str = "float32"):
        if method not in ("min-sum", "sum-product"):
            raise ValueError(f"unknown method {method!r}")
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.code, self.dev = code, device
        self.method, self.schedule = method, schedule
        self.iterations = iterations
        self.alpha = _table(alpha, iterations)
        self.beta = _table(beta, iterations)
        self.clamp = clamp
        self.early_stop = early_stop
        self.storage = storage
        self.store = store(storage)

        def t(a):
            return torch.as_tensor(a, device=device)

        E = code.E
        self.edge_var = t(code.edge_var)
        self.var_slots = t(code.var_slots)
        self.check_slots = t(code.check_slots)
        self.check_pad = self.check_slots == E
        # where each real edge sits in the flattened check layout
        flat = code.check_slots.reshape(-1)
        pos = torch.empty(E, dtype=torch.int64)
        real = flat < E
        pos[torch.as_tensor(flat[real])] = torch.nonzero(
            torch.as_tensor(real)).reshape(-1)
        self.check_pos = pos.to(device)
        self.rows = []
        for checks in code.block_rows:
            slots = code.check_slots[checks]
            slots = slots[:, (slots < E).any(0)]
            if (slots == E).any():
                # a block row's checks share one degree in a QC code
                raise ValueError("a block row with checks of two degrees")
            self.rows.append((t(slots), t(code.edge_var[slots])))
        # the parity checks' variables, padded with a variable that is 0
        vs = code.edge_var[code.check_slots.clip(max=E - 1)]
        vs[code.check_slots == E] = code.n
        self.check_vars = t(vs)

    # -- the check rule ---------------------------------------------------
    def check_rule(self, x: torch.Tensor, it: int,
                   pad: torch.Tensor | None) -> torch.Tensor:
        """(..., d) variable-to-check messages -> check-to-variable ones;
        ``pad`` marks slots that hold no edge."""
        neg = (x < 0).to(torch.float32)
        if pad is not None:
            neg = torch.where(pad, 0.0, neg)
        others_neg = neg.sum(-1, keepdim=True) - neg
        sign = 1.0 - 2.0 * torch.remainder(others_neg, 2.0)
        if self.method == "min-sum":
            a = x.abs()
            if pad is not None:
                a = torch.where(pad, BIG, a)
            # the least of the other slots: the row's least, or at the
            # slot that holds it, the least of the rest
            low, at = a.min(-1, keepdim=True)
            slot = torch.arange(a.shape[-1], device=a.device) == at
            least = torch.where(slot, torch.where(slot, BIG, a).amin(
                -1, keepdim=True), low)
            mag = torch.clamp_min(least - self.beta[it], 0.0) \
                * self.alpha[it]
        else:
            f = _phi(torch.clamp_min(x.abs(), SP_FLOOR))
            if pad is not None:
                f = torch.where(pad, 0.0, f)
            total = torch.zeros_like(f[..., 0])
            for s in range(f.shape[-1]):
                total = total + f[..., s]
            mag = _phi(torch.clamp_min(total[..., None] - f, SP_FLOOR))
        y = sign * mag
        if self.clamp is not None:
            y = torch.clamp(y, -self.clamp, self.clamp)
        return y

    # -- schedules ----------------------------------------------------------
    def _posterior(self, lch, c2v):
        """Channel value plus the check messages, in ascending check
        order; ``c2v`` has a zero column for the padding."""
        post = lch
        for s in range(self.var_slots.shape[1]):
            slot = self.var_slots[:, s]
            real = slot < self.code.E
            post = torch.where(real, post + c2v[:, slot], post)
        return self.store(post)

    def _flooding(self, lch, c2v, it):
        post = self._posterior(lch, c2v)
        v2c = self.store(post[:, self.edge_var] - c2v[:, :-1])
        x = torch.cat([v2c, torch.zeros_like(v2c[:, :1])], 1)
        y = self.store(self.check_rule(x[:, self.check_slots], it,
                                       self.check_pad))
        out = y.reshape(y.shape[0], -1)[:, self.check_pos]
        return torch.cat([out, torch.zeros_like(out[:, :1])], 1)

    def _layered(self, post, c2v, it):
        for slots, vars_ in self.rows:
            old = c2v[:, slots]
            y = self.check_rule(post[:, vars_] - old, it, None)
            new = self.store(y)
            post[:, vars_] = self.store(post[:, vars_] + (y - old))
            c2v[:, slots] = new
        return post, c2v

    def _hard_ok(self, post):
        bits = (post < 0).to(torch.int8)
        ext = torch.cat([bits, torch.zeros_like(bits[:, :1])], 1)
        par = ext[:, self.check_vars].to(torch.int32).sum(-1) & 1
        return bits, (par == 0).all(-1)

    def decode(self, llr: torch.Tensor):
        """(B, n) channel LLRs log(Pr1/Pr0) -> (hard bits int8 (B, n),
        iterations run (B,) int64)."""
        B = llr.shape[0]
        lch = self.store(-llr.to(torch.float32))
        c2v = torch.zeros((B, self.code.E + 1), dtype=torch.float32,
                          device=llr.device)
        bits_out = torch.zeros((B, self.code.n), dtype=torch.int8,
                               device=llr.device)
        iters = torch.full((B,), self.iterations, dtype=torch.int64,
                           device=llr.device)
        idx = torch.arange(B, device=llr.device)
        layered = self.schedule == "layered"
        post = lch.clone() if layered else None

        def state():
            return post if layered else self._posterior(lch, c2v)

        def retire(count):
            nonlocal lch, c2v, post, idx
            bits, ok = self._hard_ok(state())
            bits_out[idx[ok]] = bits[ok]
            iters[idx[ok]] = count
            go = ~ok
            lch, c2v, idx = lch[go], c2v[go], idx[go]
            if layered:
                post = post[go]

        if self.early_stop:
            retire(0)
        for it in range(self.iterations):
            if idx.numel() == 0:
                break
            if layered:
                post, c2v = self._layered(post, c2v, it)
            else:
                c2v = self._flooding(lch, c2v, it)
            if self.early_stop:
                retire(it + 1)
        if idx.numel():
            bits_out[idx] = (state() < 0).to(torch.int8)
        return bits_out, iters


def _table(v, iterations: int) -> list[float]:
    if isinstance(v, (list, tuple)):
        if len(v) != iterations:
            raise ValueError(f"a table of {len(v)} for {iterations} "
                             "iterations")
        return [float(x) for x in v]
    return [float(v)] * iterations
