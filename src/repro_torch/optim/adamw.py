"""AdamW with warmup-cosine schedule, over dicts of tensors.

The port of `repro.optim.adamw`, with the reference's order of operations:
the global-norm clip (epsilon 1e-9) first, then the moments, the bias
corrections `1 / (1 - b ** step)` in float32, and the update
`lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)` with weight decay added to
the update.  `torch.optim.AdamW` decays as `p *= 1 - lr * wd` and
`clip_grad_norm_` adds 1e-6, so neither is used.  The step counter is an
int32 tensor on the parameters' device, so a training loop never waits for
the host.  Every quotient divides by a tensor on that device: PyTorch
computes `scalar / tensor` as `tensor.reciprocal() * scalar`, and on CUDA
`tensor / python_float` as a product with the reciprocal, and either
rounds differently from the reference's division.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                 # scalar int32
    mu: dict[str, torch.Tensor]        # first moment, like params
    nu: dict[str, torch.Tensor]        # second moment, like params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0
    warmup_steps: int = 0
    total_steps: int | None = None     # enables cosine decay when set
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """`x` as a float32 scalar on `like`'s device, filled there: a copy
    from pageable host memory would wait for the stream."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + (optional) cosine decay to min_lr_ratio * lr, in
    float32 on `step`'s device."""
    step = step.to(torch.float32)
    lr = _f32(cfg.lr, step)
    warm = decay = 1.0
    if cfg.warmup_steps > 0:
        warm = torch.clamp((step + 1.0) / _f32(cfg.warmup_steps, step),
                           max=1.0)
    if cfg.total_steps is not None:
        span = max(1, cfg.total_steps - cfg.warmup_steps)
        frac = torch.clamp((step - cfg.warmup_steps) / _f32(span, step),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return lr * warm * decay


def init(params: dict[str, torch.Tensor]) -> AdamWState:
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def state_from_arrays(step, mu: dict, nu: dict, device) -> AdamWState:
    """An `AdamWState` from the reference's state as numpy arrays (the
    step count and dicts of moments), placed on `device`."""
    def on(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    return AdamWState(
        step=torch.as_tensor(step).to(device=device, dtype=torch.int32),
        mu={k: on(v) for k, v in mu.items()},
        nu={k: on(v) for k, v in nu.items()})


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in the reference's leaf
    order (sorted keys, as `jax.tree.leaves` orders a dict)."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].to(torch.float32)))
    return torch.sqrt(total)


def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: AdamWState,
                  cfg: AdamWConfig
                  ) -> tuple[dict[str, torch.Tensor], AdamWState]:
    """One AdamW step.  Returns (new_params, new_state)."""
    step = state.step + 1
    if cfg.grad_clip is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}

    b1, b2 = cfg.b1, cfg.b2
    mu = {k: b1 * state.mu[k] + (1 - b1) * grads[k].to(torch.float32)
          for k in params}
    nu = {k: b2 * state.nu[k]
          + (1 - b2) * torch.square(grads[k].to(torch.float32))
          for k in params}
    stepf = step.to(torch.float32)
    one = _f32(1.0, stepf)
    mu_hat_scale = one / (1.0 - torch.pow(_f32(b1, stepf), stepf))
    nu_hat_scale = one / (1.0 - torch.pow(_f32(b2, stepf), stepf))
    lr = schedule(cfg, state.step)

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = {k: upd(p, mu[k], nu[k]) for k, p in params.items()}
    return new_params, AdamWState(step=step, mu=mu, nu=nu)
