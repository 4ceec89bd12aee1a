"""Fault-tolerant LM training loop.

The port of `repro.train.loop`, on one device:

  * resume      — restores the latest checkpoint; the token pipeline is
    stateless in (seed, step), so the data stream continues exactly;
  * preemption  — SIGTERM/SIGINT set a flag; the loop checkpoints after
    the step in flight and exits;
  * stragglers  — per-step wall time is kept; a step slower than
    `straggler_factor` x the running median of the last 50 is logged with
    its step id (`StepStats`, the reference's rule);
  * periodic checkpoints every `ckpt_every` steps and at the end, with
    retention, optionally written on a background thread
    (`checkpoint.CheckpointManager`, the reference's on-disk layout: a
    checkpoint of either framework restores in the other);
  * microbatching — gradients summed over `microbatches` chunks of the
    batch in `cfg.accum_dtype`, then divided by their number;
  * gradient compression — optional int8 error feedback between the
    accumulation and the update (`optim.grad_compress`);
  * the optimizer — AdamW, with int8 moments when `cfg.opt_8bit`.

While a profiler records, a step records the spans `train.step`,
`train.microbatch` (each `grads_of`; its index and tokens; with the
model's `model.loss` and `model.loss.backward` inside),
`train.accumulate` (the sum's allocation, each addition, the mean),
`train.update` and, inside it, `train.compress` (`repro_torch.trace`).

Autograd is PyTorch's (`torch.autograd.grad` of `models.transformer.
loss_fn` with respect to every parameter leaf); there is no `jit` and no
buffer donation.  A step waits for the device once, when the loop reads
its loss (the reference's `block_until_ready`).  `"ternary_packed"`
weights cannot be trained (the reference trains `"dense"` and
`"ternary"`, whose straight-through quantizer lives in `models.layers`).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch import trace as TR
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw, adamw8bit
from repro_torch.optim.adamw import _f32, tree_map
from repro_torch.optim.grad_compress import compress_grads


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    grad_compress: bool = False
    background_ckpt: bool = False
    optimizer: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


def _unflatten(paths: list[tuple], leaves: list) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def grads_of(cfg: ModelConfig, params: dict, batch: dict
             ) -> tuple[dict, dict]:
    """`(dL/dparams, metrics)` of `loss_fn` on one batch: gradients in
    each parameter's dtype (zeros for a leaf the loss does not read, as
    JAX gives), metrics detached."""
    if cfg.quant == "ternary_packed":
        raise ValueError(f"{cfg.name}: packed ternary weights cannot be "
                         "trained; train quant='ternary' and pack after")
    paths = [path for path, _ in P.leaves(params)]
    leaves = [p.detach().requires_grad_() for _, p in P.leaves(params)]
    loss, metrics = TF.loss_fn(cfg, _unflatten(paths, leaves), batch)
    # closed by `chunked_ce_loss`'s hook once the loss's backward is done
    TR.begin("model.loss.backward")
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, gs)]
    return (_unflatten(paths, grads),
            {k: v.detach() for k, v in metrics.items()})


def accumulator(params: dict, acc_dt: torch.dtype) -> dict:
    """A zero gradient sum shaped like `params`, in `acc_dt`."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                          device=p.device), params)


def accumulate_(gsum: dict, grads: dict, acc_dt: torch.dtype) -> None:
    """`gsum += grads` leaf by leaf, in `acc_dt`."""
    tree_map(lambda a, b: a.add_(b.to(acc_dt)), gsum, grads)


def averaged(gsum: dict, n_mb: int, like: torch.Tensor) -> dict:
    """The mean gradient of `n_mb` microbatches from their sum."""
    div = _f32(n_mb, like)
    return tree_map(lambda g: g / div, gsum)


def update(cfg: ModelConfig, loop_cfg: TrainLoopConfig, params: dict,
           grads: dict, opt_state, err_buf=None):
    """The step after the gradients: optional compression, then one
    optimizer update.  Returns `(params, opt_state, err_buf)`."""
    with TR.span("train.update"):
        if loop_cfg.grad_compress and err_buf is not None:
            with TR.span("train.compress"):
                grads, err_buf = compress_grads(grads, err_buf)
        opt_mod = adamw8bit if cfg.opt_8bit else adamw
        params, opt_state = opt_mod.apply_updates(params, grads, opt_state,
                                                  loop_cfg.optimizer)
    return params, opt_state, err_buf


def make_train_step(cfg: ModelConfig, loop_cfg: TrainLoopConfig) -> Callable:
    """`train_step(params, opt_state, batch, err_buf=None) -> (params,
    opt_state, metrics, err_buf)`: gradients (accumulated over
    microbatches), optional compression, then one optimizer update
    (AdamW, int8 moments per `cfg.opt_8bit`)."""
    acc_dt = P.DTYPES[cfg.accum_dtype]

    def train_step(params, opt_state, batch, err_buf=None):
        with TR.span("train.step"):
            n_mb = loop_cfg.microbatches
            if n_mb > 1:
                B = batch["tokens"].shape[0]
                if B % n_mb:
                    raise ValueError(f"batch {B} does not split into {n_mb} "
                                     "microbatches")
                with TR.span("train.accumulate"):
                    gsum = accumulator(params, acc_dt)
                nll = ntok = None
                for i in range(n_mb):
                    mb = {k: v.reshape(n_mb, B // n_mb, *v.shape[1:])[i]
                          for k, v in batch.items()}
                    with TR.span("train.microbatch", index=i,
                                 tokens=mb["tokens"].numel()):
                        g, met = grads_of(cfg, params, mb)
                    with TR.span("train.accumulate"):
                        accumulate_(gsum, g, acc_dt)
                    del g
                    nll = met["nll"] if nll is None else nll + met["nll"]
                    ntok = (met["tokens"] if ntok is None
                            else ntok + met["tokens"])
                with TR.span("train.accumulate"):
                    grads = averaged(gsum, n_mb, ntok)
                metrics = {"loss": nll / torch.clamp(ntok, min=1.0),
                           "nll": nll, "tokens": ntok,
                           "moe_aux": torch.zeros_like(nll)}
            else:
                with TR.span("train.microbatch", index=0,
                             tokens=batch["tokens"].numel()):
                    grads, metrics = grads_of(cfg, params, batch)
            params, opt_state, err_buf = update(cfg, loop_cfg, params, grads,
                                                opt_state, err_buf)
            return params, opt_state, metrics, err_buf

    return train_step


@dataclass
class StepStats:
    times: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)

    def record(self, step: int, dt: float, factor: float) -> bool:
        self.times.append(dt)
        med = float(np.median(self.times[-50:]))
        slow = len(self.times) > 5 and dt > factor * med
        if slow:
            self.stragglers.append((step, dt, med))
        return slow


class Trainer:
    """Orchestrates train_step + checkpointing + fault handling on
    `device` (None: the current CUDA device); batches from `pipeline`
    are moved there."""

    def __init__(self, cfg: ModelConfig, loop_cfg: TrainLoopConfig,
                 pipeline, ckpt_dir: str, device=None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=loop_cfg.keep_ckpts)
        self.stats = StepStats()
        self._preempted = False
        self.train_step = make_train_step(cfg, loop_cfg)

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass   # not the main thread
        return previous

    def _state(self, params, opt_state) -> dict:
        return {"params": params, "opt": opt_state}

    def run(self, params, opt_state, start_step: int = 0, err_buf=None,
            log: Callable[[str], None] = print):
        previous = self._install_signal_handlers()
        try:
            return self._run(params, opt_state, start_step, err_buf, log)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self, params, opt_state, step, err_buf, log):
        lc = self.loop_cfg
        losses = []
        while step < lc.total_steps:
            t0 = time.monotonic()
            batch = {k: v.to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            params, opt_state, metrics, err_buf = self.train_step(
                params, opt_state, batch, err_buf)
            losses.append(float(metrics["loss"]))     # the step's one sync
            dt = time.monotonic() - t0
            if self.stats.record(step, dt, lc.straggler_factor):
                log(f"[straggler] step {step}: {dt:.2f}s "
                    f"(median {np.median(self.stats.times[-50:]):.2f}s)")
            step += 1
            if step % lc.log_every == 0:
                log(f"step {step}: loss={losses[-1]:.4f} ({dt:.2f}s/step)")
            if step % lc.ckpt_every == 0 or step == lc.total_steps:
                self.ckpt.save(step, self._state(params, opt_state),
                               extra={"loss": losses[-1]},
                               background=lc.background_ckpt)
            if self._preempted:
                log(f"[preempt] checkpointing at step {step} and exiting")
                self.ckpt.wait()
                self.ckpt.save(step, self._state(params, opt_state),
                               extra={"loss": losses[-1], "preempted": True})
                break
        self.ckpt.wait()
        return params, opt_state, {"losses": losses,
                                   "stragglers": self.stats.stragglers,
                                   "last_step": step}

    def resume_or_init(self, init_fn: Callable[[], tuple]):
        """Restore the latest checkpoint if there is one, else initialize
        fresh: `(params, opt_state, start step)`.  `init_fn` gives the
        template either way (structure and dtypes)."""
        params0, opt0 = init_fn()
        if self.ckpt.latest_step() is None:
            return params0, opt0, 0
        step, state, _ = self.ckpt.restore(self._state(params0, opt0),
                                           device=self.device)
        return state["params"], state["opt"], step
