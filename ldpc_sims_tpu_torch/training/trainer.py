"""Training recipes for the neural LLR estimators, the joint model and the
trained decoders (the port of ``training/trainer.py``).

Each recipe is the JAX package's, on ``torch.optim``:

* ``optax.sgd(lr)`` → ``torch.optim.SGD(lr)``, ``optax.adam(lr)`` →
  ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``; the joint
  recipe's ``optax.multi_transform`` (5× lr on the LLR net) → two param
  groups of one optimizer;
* the weighted-MSE loss with ε = 1e-3, the BCE on decoded soft bits;
* the data order of NumPy's ``default_rng(cfg.seed)``: the holdout
  split, each epoch's permutation and each eval draw are JAX's, so a run
  can be held to JAX's batch for batch;
* device residency: the dataset crosses to the device once, the index
  tensors once per chunk of ``eval_every`` epochs, and the losses stay
  device tensors until the chunk's end (no read per step);
* checkpoints in the JAX package's layout (:mod:`..utils.checkpoint`):
  ``{"params": <flax tree>, "opt_state": <optax layout>}`` for
  :func:`train_llr` and :func:`train_joint` (:mod:`..convert`), the flat
  weight dict with its info manifest for :func:`train_neural_bp` and
  :func:`train_minsum_weights`.

Every gradient decode is a plain PyTorch one: ``bp_decode``'s ``auto``
sends a decode whose weights or LLRs need a gradient to the roll backend
(QC codes) or the gather backend, as the JAX package trains through its
roll, dense and gather backends. :func:`decoded_ber_probe` decodes under
``torch.no_grad()``, so on the card a trained decoder runs through the
CUDA kernels.

Each recipe's step (loss, backward, optimizer step) is a function of its
own (:func:`llr_step`, :func:`joint_step`, :func:`neural_bp_step`,
:func:`minsum_step`) that takes a batch of tensors, so a test can feed
it a shared NumPy batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ldpc_sims_tpu_torch.convert import (
    joint_params_to_flax,
    joint_state_dict_from_flax,
    llr_params_to_flax,
    llr_state_dict_from_flax,
    optimizer_state_to_flax,
)
from ldpc_sims_tpu_torch.ops.bp import (
    bp_decode,
    init_minsum_weights,
    init_neural_bp_weights,
)
from ldpc_sims_tpu_torch.ops.phy import weighted_mse
from ldpc_sims_tpu_torch.utils.checkpoint import save_checkpoint
from ldpc_sims_tpu_torch.utils.device import resolve_device

__all__ = [
    "TrainConfig",
    "bce",
    "decoded_ber_probe",
    "joint_step",
    "llr_step",
    "minsum_batch",
    "minsum_step",
    "neural_bp_step",
    "train_joint",
    "train_llr",
    "train_minsum_weights",
    "train_neural_bp",
]

_BCE_EPS = 1e-7  # inside the logs of the BCE, as in the JAX package
# the joint optimizer's param groups, as optax.multi_transform's labels
_JOINT_GROUPS = {"llr": 0, "bp": 1}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's training configuration, field for field."""

    learning_rate: float = 0.01
    num_epochs: int = 100
    batch_size: int = 4096
    eval_every: int = 10
    eval_samples: int = 1024
    # fraction of samples held out of training for the periodic eval
    # (0.0: evaluate on the training data, as the reference does)
    holdout_fraction: float = 1.0 / 16.0
    epsilon: float = 1e-3
    seed: int = 0
    # 'sgd' (the reference's pick) or 'adam'
    optimizer: str = "sgd"
    # joint-recipe extras: the gradient-accumulation chunk and the LLR
    # net's learning-rate multiplier
    minibatch_size: int = 512
    llr_lr_multiplier: float = 5.0

    def make_optimizer(self, params, lr: float | None = None
                       ) -> torch.optim.Optimizer:
        """``torch.optim.SGD`` or ``Adam`` (optax's defaults) over
        ``params`` (tensors, or param-group dicts) at ``lr`` (default
        ``learning_rate``)."""
        if self.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        lr = self.learning_rate if lr is None else lr
        if self.optimizer == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        return torch.optim.SGD(params, lr=lr)


def _flipped_stats(y_est: np.ndarray, y: np.ndarray) -> dict[str, float]:
    """The reference's sign-flip diagnostics (``ofdm/ofdm_nn.py:96-106``)."""
    flips = np.abs(np.sign(y_est) - np.sign(y))
    num_flipped = float(np.mean(flips))
    vals = np.abs(y[flips != 0])
    if vals.size == 0:
        return {"flipped_ber": 0.0}
    return {
        "flipped_ber": num_flipped,
        "flipped_mean": float(vals.mean()),
        "flipped_median": float(np.median(vals)),
        "flipped_max": float(vals.max()),
    }


def _seed(*parts: int) -> int:
    """A generator seed from integers (the JAX package's ``fold_in``)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1)[0])


def _to_device(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)


def _init_module(model: torch.nn.Module, init_params, seed: int, dev,
                 from_flax: Callable) -> torch.nn.Module:
    """``init_params`` (a flax tree ``{"params": ...}`` or a state dict)
    loaded into ``model``, or a fresh draw from a CPU generator seeded
    with ``seed``, so every device starts from the same parameters; then
    the module on ``dev``."""
    model.to("cpu")
    if init_params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(from_flax(init_params) if "params"
                              in init_params else init_params)
    return model.to(dev)


def _trainable(weights, dev) -> dict[str, torch.Tensor]:
    """Decoder weights (NumPy or tensors) as float32 leaf tensors on
    ``dev`` that require a gradient."""
    return {k: torch.as_tensor(v, dtype=torch.float32).detach().to(dev)
            .clone().requires_grad_() for k, v in weights.items()}


def bce(p1: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of soft bits Pr(bit=1) against 0/1 targets,
    with ε = 1e-7 inside the logs (the JAX package's)."""
    b = bits.to(torch.float32)
    return -torch.mean(b * torch.log(p1 + _BCE_EPS)
                       + (1 - b) * torch.log(1 - p1 + _BCE_EPS))


def _step(opt: torch.optim.Optimizer, loss_fn: Callable) -> torch.Tensor:
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


def llr_step(model, opt, x: torch.Tensor, y: torch.Tensor,
             epsilon: float = 1e-3) -> torch.Tensor:
    """One step of the LLR recipe: weighted MSE of ``model(x)`` against
    the LLRs ``y``, backward, optimizer step; returns the loss."""
    return _step(opt, lambda: weighted_mse(model(x), y, epsilon))


def joint_step(model, opt, x: torch.Tensor, bits: torch.Tensor,
               n_mb: int) -> torch.Tensor:
    """One batch of the joint recipe: the BCE gradient accumulated over
    ``n_mb`` equal minibatches (``x``'s rows and ``bits``' codewords in
    minibatch order), their mean applied in one optimizer step; returns
    the mean loss."""
    opt.zero_grad(set_to_none=True)
    total = torch.zeros((), device=x.device)
    for xm, bm in zip(x.chunk(n_mb), bits.chunk(n_mb)):
        loss = bce(model(xm), bm)
        (loss / n_mb).backward()
        total = total + loss.detach()
    opt.step()
    return total / n_mb


def neural_bp_step(weights: dict, opt, code, llr: torch.Tensor,
                   bits: torch.Tensor, **decode_kw) -> torch.Tensor:
    """One step of the neural-BP recipe: BCE of the soft decode with
    ``weights`` against ``bits``, backward, optimizer step."""
    return _step(opt, lambda: bce(bp_decode(
        llr, code, weights=weights, output="soft", **decode_kw), bits))


def minsum_step(weights: dict, opt, code, llr: torch.Tensor,
                **decode_kw) -> torch.Tensor:
    """One step of the (α, β) recipe: the BCE of the soft min-sum decode
    against the all-zero codeword, backward, optimizer step."""
    return _step(opt, lambda: -torch.mean(torch.log(1.0 - bp_decode(
        llr, code, method="min-sum", weights=weights, output="soft",
        **decode_kw) + _BCE_EPS)))


def minsum_batch(gen: torch.Generator, code, batch: int, lo: float,
                 hi: float) -> torch.Tensor:
    """LLRs of all-zero codewords over BPSK/AWGN at a per-codeword SNR
    uniform in dB over [lo, hi], drawn on the generator's device."""
    dev = gen.device
    snr = 10.0 ** ((lo + (hi - lo) * torch.rand(
        (batch, 1), generator=gen, device=dev)) / 10.0)
    sigma = torch.rsqrt(snr)
    r = 1.0 + sigma * torch.randn((batch, code.n), generator=gen,
                                  device=dev)
    return -2.0 * r / (sigma * sigma)


def train_llr(
    model: torch.nn.Module,
    input_samples: np.ndarray,
    output_samples: np.ndarray,
    cfg: TrainConfig,
    init_params: Any | None = None,
    ckpt_dir: str | None = None,
    manifest: dict | None = None,
    log: Callable[[str], None] | None = print,
    metrics: Any | None = None,
    device="cuda",
):
    """Train an LLR estimator with weighted MSE.

    ``model``: one of :mod:`..models.llr`'s estimators; ``init_params`` a
    flax tree or state dict to start from (default: a fresh draw seeded
    with ``cfg.seed``). Returns ``(model, info)``, the model trained in
    place on ``device`` and ``info`` with the per-epoch ``train_loss``.
    ``metrics``: an optional MetricsLogger, one 'train-epoch' event per
    eval interval.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    n_hold = int(input_samples.shape[0] * cfg.holdout_fraction)
    if n_hold:
        # held-out eval slice, split once before the epoch loop
        perm = rng.permutation(input_samples.shape[0])
        hold, train = perm[:n_hold], perm[n_hold:]
        hold_x, hold_y = input_samples[hold], output_samples[hold]
        input_samples = input_samples[train]
        output_samples = output_samples[train]
    else:  # the reference's behaviour: eval on the training data
        hold_x, hold_y = input_samples, output_samples
    num_samples = input_samples.shape[0]
    eff_bs = min(cfg.batch_size, num_samples)
    num_batches = max(num_samples // eff_bs, 1)

    model = _init_module(model, init_params, cfg.seed, dev,
                         llr_state_dict_from_flax)
    opt = cfg.make_optimizer(model.parameters())
    x_dev, y_dev = _to_device(input_samples, dev), _to_device(
        output_samples, dev)
    hold_x_dev, hold_y_dev = _to_device(hold_x, dev), _to_device(hold_y, dev)

    train_loss = np.zeros(max(cfg.num_epochs, 1))
    t0 = time.perf_counter()
    chunk = max(cfg.eval_every, 1)
    epoch = 0
    while epoch < cfg.num_epochs:
        n_ep = min(chunk, cfg.num_epochs - epoch)
        idx = torch.from_numpy(np.stack([
            rng.permutation(num_samples)[: num_batches * eff_bs]
            .reshape(num_batches, eff_bs)
            for _ in range(n_ep)
        ])).to(dev)
        losses = torch.empty((n_ep, num_batches), device=dev)
        for e in range(n_ep):
            for b in range(num_batches):
                ib = idx[e, b]
                losses[e, b] = llr_step(model, opt, x_dev[ib], y_dev[ib],
                                        cfg.epsilon)
        train_loss[epoch: epoch + n_ep] = losses.mean(1).cpu().numpy()
        epoch += n_ep
        # eval at each chunk boundary
        eidx = rng.choice(hold_x.shape[0],
                          min(cfg.eval_samples, hold_x.shape[0]),
                          replace=False)
        with torch.no_grad():
            ei = torch.from_numpy(eidx).to(dev)
            est = model(hold_x_dev[ei])
            test_loss = float(weighted_mse(est, hold_y_dev[ei], cfg.epsilon))
        stats = _flipped_stats(est.cpu().numpy(), hold_y[eidx])
        if metrics is not None:
            metrics.log(
                "train-epoch", epoch=epoch - 1,
                train_loss=float(train_loss[epoch - 1]),
                test_loss=test_loss, **stats,
            )
        if log:
            log(f"[epoch {epoch}] train_loss: {train_loss[epoch - 1]:.3f}, "
                f"test_loss: {test_loss:.3f}, flipped_ber: "
                f"{stats['flipped_ber']:.3f}")

    info = {
        "train_loss": train_loss,
        "wall_s": time.perf_counter() - t0,
        "epochs": cfg.num_epochs,
    }
    if ckpt_dir:
        save_checkpoint(
            ckpt_dir,
            {"params": llr_params_to_flax(model),
             "opt_state": optimizer_state_to_flax(opt, model)},
            {**(manifest or {}), **info,
             "config": dataclasses.asdict(cfg)},
        )
    return model, info


def train_joint(
    model: torch.nn.Module,
    input_samples: np.ndarray,
    target_bits: np.ndarray,
    cfg: TrainConfig,
    init_params: Any | None = None,
    llr_warm_start: Any | None = None,
    ckpt_dir: str | None = None,
    manifest: dict | None = None,
    log: Callable[[str], None] | None = print,
    device="cuda",
):
    """Joint (LLR net → BP) end-to-end training with BCE on the decoded
    bits, the LLR net's group at ``cfg.llr_lr_multiplier`` × the rate.

    ``model``: a :class:`..models.Joint`. ``init_params``: a flax tree or
    state dict of the whole model (default: a fresh draw seeded with
    ``cfg.seed`` and all-ones decoder weights). ``llr_warm_start``: the
    params (flax tree or state dict) of a trained LLR estimator, grafted
    into ``LLRest``. Returns ``(model, info)``: ``info['train_loss']`` per
    epoch and ``info['holdout']``, the held-out decoded BER and loss every
    ``eval_every`` epochs.
    """
    dev = resolve_device(device)
    num_samples = input_samples.shape[0]
    sym_per_cw = num_samples // target_bits.shape[0]
    cw_per_minibatch = max(cfg.minibatch_size // sym_per_cw, 1)

    model = _init_module(model, init_params, cfg.seed, dev,
                         joint_state_dict_from_flax)
    if llr_warm_start is not None:
        model.LLRest.load_state_dict(
            llr_state_dict_from_flax(llr_warm_start)
            if "params" in llr_warm_start else llr_warm_start)
    bp_params = [p for n, p in model.named_parameters()
                 if not n.startswith("LLRest.")]
    opt = cfg.make_optimizer([
        {"params": list(model.LLRest.parameters()),
         "lr": cfg.learning_rate * cfg.llr_lr_multiplier},
        {"params": bp_params},
    ])

    rng = np.random.default_rng(cfg.seed)
    num_cw = target_bits.shape[0]
    sym_off = np.arange(sym_per_cw)

    def rows(cw: np.ndarray) -> np.ndarray:
        return (cw[:, None] * sym_per_cw + sym_off).reshape(-1)

    # a codeword-aligned held-out slice, probed every eval_every epochs
    n_hold_cw = int(num_cw * cfg.holdout_fraction)
    hold_x = hold_bits = None
    train_x, train_bits = input_samples, target_bits
    if n_hold_cw:
        hperm = rng.permutation(num_cw)
        hold_cw, train_cw = hperm[:n_hold_cw], hperm[n_hold_cw:]
        hold_x = _to_device(input_samples[rows(hold_cw)], dev)
        hold_bits = _to_device(target_bits[hold_cw], dev)
        num_cw = train_cw.shape[0]
        train_x = input_samples[rows(train_cw)]
        train_bits = target_bits[train_cw]
    x_dev, bits_dev = _to_device(train_x, dev), _to_device(train_bits, dev)

    cw_per_minibatch = min(cw_per_minibatch, num_cw)
    bs_cw = max(cfg.batch_size // sym_per_cw, cw_per_minibatch)
    num_batches = max(num_cw // bs_cw, 1)
    n_mb = max(min(bs_cw, num_cw) // cw_per_minibatch, 1)
    sym_off_dev = torch.arange(sym_per_cw, device=dev)
    train_loss = np.zeros(cfg.num_epochs)
    holdout = []

    for epoch in range(cfg.num_epochs):
        perm = torch.from_numpy(rng.permutation(num_cw)).to(dev)
        losses = []
        for b in range(num_batches):
            cw = perm[b * bs_cw: b * bs_cw + n_mb * cw_per_minibatch]
            sym = (cw[:, None] * sym_per_cw + sym_off_dev).reshape(-1)
            losses.append(joint_step(model, opt, x_dev[sym], bits_dev[cw],
                                     n_mb))
        train_loss[epoch] = (float(torch.stack(losses).mean())
                             if losses else 0.0)
        if epoch % cfg.eval_every == 0:
            line = (f"[epoch {epoch + 1}] joint train_loss: "
                    f"{train_loss[epoch]:.4f}")
            if hold_x is not None:
                with torch.no_grad():
                    p1 = model(hold_x)
                    hber = float(((p1 > 0.5) != (hold_bits > 0))
                                 .to(torch.float32).mean())
                    hloss = float(bce(p1, hold_bits))
                holdout.append({"epoch": epoch, "ber": hber, "loss": hloss})
                line += (f", holdout decoded-BER: {hber:.4e}, "
                         f"holdout loss: {hloss:.4f}")
            if log:
                log(line)

    info = {"train_loss": train_loss, "holdout": holdout}
    if ckpt_dir:
        save_checkpoint(
            ckpt_dir,
            {"params": joint_params_to_flax(model),
             "opt_state": optimizer_state_to_flax(opt, model,
                                                  _JOINT_GROUPS)},
            {**(manifest or {}), "train_loss": train_loss,
             "holdout": holdout, "config": dataclasses.asdict(cfg)},
        )
    return model, info


def decoded_ber_probe(
    code,
    snr_db: tuple[float, ...],
    batch: int = 512,
    device=None,
    **decode_kw,
):
    """A held-out decoded-BER probe for decoder training.

    Returns ``probe(weights, seed) -> {snr: ber}``: fresh all-zero-codeword
    BPSK/AWGN batches at each ``snr_db`` point, drawn from a generator
    seeded with ``seed`` on ``device`` (default: the weights' device),
    decoded under ``torch.no_grad()`` with the weights detached and
    ``output='hard'``. So on the card the decode runs through the CUDA
    kernels (edge weights: the ``_w`` kernels; ``ms_alpha``/``ms_beta``:
    the α/β table), and the trained tensors' ``.grad`` stay as they were.
    """
    snrs = tuple(float(s) for s in snr_db)

    def probe(weights, seed: int) -> dict[float, float]:
        w = None if weights is None else {
            k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in weights.items()}
        dev = device
        if dev is None:
            dev = next((v.device for v in (w or {}).values()
                        if isinstance(v, torch.Tensor)), "cuda")
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        bers = []
        with torch.no_grad():
            for s in snrs:
                sigma = (10.0 ** (s / 10.0)) ** -0.5
                r = 1.0 + sigma * torch.randn((batch, code.n),
                                              generator=gen, device=dev)
                bits = bp_decode(-2.0 * r / (sigma * sigma), code,
                                 weights=w, output="hard", **decode_kw)
                bers.append(bits.to(torch.float32).mean())
        return dict(zip(snrs, torch.stack(bers).tolist()))

    return probe


def train_neural_bp(
    code,
    llrs: np.ndarray,
    target_bits: np.ndarray,
    cfg: TrainConfig,
    iterations: int = 5,
    method: str = "sum-product",
    clamp: float = 20.0,
    schedule: str = "flooding",
    probe_snr_db: tuple[float, ...] = (),
    probe_batch: int = 512,
    init_weights: Any | None = None,
    ckpt_dir: str | None = None,
    log: Callable[[str], None] | None = print,
    device="cuda",
):
    """Train per-edge neural-BP weights alone (Nachmani et al. 2016
    style) with adam at ``cfg.learning_rate``; ``schedule='layered'``
    trains weighted serial-C sweeps. ``probe_snr_db``: SNR points of a
    held-out decoded-BER probe every ``eval_every`` epochs (include one
    beyond the training window), its results in ``info['probe']``.
    Returns ``(weights, info)``: the trained weights as detached tensors
    on ``device``, ``info['loss']`` per step."""
    dev = resolve_device(device)
    weights = _trainable(init_weights if init_weights is not None
                         else init_neural_bp_weights(code, iterations), dev)
    opt = torch.optim.Adam(weights.values(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    decode_kw = dict(iterations=iterations, method=method, clamp=clamp,
                     schedule=schedule)
    probe = (decoded_ber_probe(code, probe_snr_db, batch=probe_batch,
                               device=dev, **decode_kw)
             if probe_snr_db else None)

    rng = np.random.default_rng(cfg.seed)
    n = llrs.shape[0]
    num_batches = max(n // cfg.batch_size, 1)
    llr_dev, bits_dev = _to_device(llrs, dev), _to_device(target_bits, dev)
    losses = []
    probes = []
    for epoch in range(cfg.num_epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for b in range(num_batches):
            idx = perm[b * cfg.batch_size: (b + 1) * cfg.batch_size]
            losses.append(neural_bp_step(weights, opt, code, llr_dev[idx],
                                         bits_dev[idx], **decode_kw))
        if epoch % cfg.eval_every == 0:
            line = (f"[epoch {epoch + 1}] neural-BP loss: "
                    f"{float(losses[-1]):.4f}")
            if probe is not None:
                bers = probe(weights, _seed(cfg.seed + 1, epoch))
                probes.append({"epoch": epoch, "ber": bers})
                line += "  probe " + " ".join(
                    f"{s}dB:{v:.2e}" for s, v in bers.items())
            if log:
                log(line)
    weights = {k: v.detach() for k, v in weights.items()}
    info = {"loss": torch.stack(losses).tolist() if losses else [],
            "probe": probes}
    if ckpt_dir:
        save_checkpoint(ckpt_dir, weights, info)
    return weights, info


def train_minsum_weights(
    code,
    cfg: TrainConfig,
    iterations: int = 10,
    schedule: str = "layered",
    snr_db: tuple[float, float] = (1.0, 3.0),
    steps: int = 200,
    batch: int = 512,
    clamp: float | None = None,
    probe_snr_db: tuple[float, ...] = (),
    probe_batch: int = 512,
    init_weights: Any | None = None,
    ckpt_dir: str | None = None,
    log: Callable[[str], None] | None = print,
    device="cuda",
):
    """Train a per-iteration normalized/offset min-sum schedule (α_t, β_t).

    2·``iterations`` parameters, trained by BCE through the unrolled
    plain decode (roll backend for a QC code) on batches drawn on the
    device each step from a generator seeded with ``cfg.seed``: all-zero
    codewords over BPSK/AWGN at a per-codeword SNR uniform in ``snr_db``
    (the weighted min-sum update is odd in the messages, so the all-zero
    codeword gives an unbiased BER). Frozen with
    :func:`..ops.bp.freeze_minsum_weights`, the schedule runs in the
    kernels' α/β table.

    Returns ``(weights, info)``: the trained ``ms_alpha``/``ms_beta`` as
    detached tensors, ``info['loss']`` the per-step BCE and
    ``info['alpha']``/``info['beta']`` the schedule as lists.
    """
    dev = resolve_device(device)
    weights = _trainable(init_weights if init_weights is not None
                         else init_minsum_weights(iterations), dev)
    opt = cfg.make_optimizer(weights.values())
    lo, hi = float(snr_db[0]), float(snr_db[1])
    decode_kw = dict(iterations=iterations, clamp=clamp, schedule=schedule)
    probe = (decoded_ber_probe(code, probe_snr_db, batch=probe_batch,
                               device=dev, method="min-sum", **decode_kw)
             if probe_snr_db else None)

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    losses = []
    probes = []
    t0 = time.time()
    for i in range(steps):
        llr = minsum_batch(gen, code, batch, lo, hi)
        losses.append(minsum_step(weights, opt, code, llr, **decode_kw))
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            line = (f"[step {i + 1}/{steps}] minsum-weight BCE "
                    f"{float(losses[-1]):.5f} ({time.time() - t0:.0f}s)")
            if probe is not None:
                bers = probe(weights, _seed(cfg.seed + 1, i))
                probes.append({"step": i, "ber": bers})
                line += "  probe " + " ".join(
                    f"{s}dB:{v:.2e}" for s, v in bers.items())
            if log:
                log(line)
    weights = {k: v.detach() for k, v in weights.items()}
    info = {
        "loss": torch.stack(losses).tolist() if losses else [],
        "alpha": weights["ms_alpha"].tolist(),
        "beta": weights["ms_beta"].tolist(),
        "iterations": iterations,
        "schedule": schedule,
        "snr_db": [lo, hi],
        "probe": probes,
    }
    if ckpt_dir:
        save_checkpoint(ckpt_dir, weights, info)
    return weights, info
