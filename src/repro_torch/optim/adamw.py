"""AdamW with warmup-cosine schedule, over nested dicts of tensors.

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

Parameters, gradients and moments are nested dicts of tensors (a TNN's
flat `{"w1", "w2"}`, an LM's parameter tree); `tree_leaves` and
`tree_map` walk them in the reference's leaf order, sorted keys at each
level, as `jax.tree.leaves` orders a dict.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                 # scalar int32
    mu: dict                           # first moment, like params
    nu: dict                           # second moment, like params


def tree_leaves(tree: dict) -> list:
    """The leaves of a nested dict in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """`fn` over the leaves of `tree` and of the like-shaped `rest`."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


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


def init(params: dict) -> AdamWState:
    dev = tree_leaves(params)[0].device
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=tree_map(torch.clone, mu))


def state_from_arrays(step, mu: dict, nu: dict, device) -> AdamWState:
    """An `AdamWState` from the reference's state as numpy arrays (the
    step count and nested dicts of moments), placed on `device`."""
    def on(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    return AdamWState(
        step=torch.as_tensor(step).to(device=device, dtype=torch.int32),
        mu=tree_map(on, mu), nu=tree_map(on, nu))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in the reference's leaf
    order (sorted keys, as `jax.tree.leaves` orders a dict)."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def clip_scale(cfg: AdamWConfig, grads: dict) -> torch.Tensor | None:
    """The global-norm clip's factor `min(1, clip / (norm + 1e-9))`, or
    None without a clip."""
    if cfg.grad_clip is None:
        return None
    gnorm = global_norm(grads)
    return torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), max=1.0)


def bias_scales(cfg: AdamWConfig, step: torch.Tensor):
    """`1 / (1 - b1 ** step)` and `1 / (1 - b2 ** step)` in float32."""
    stepf = step.to(torch.float32)
    one = _f32(1.0, stepf)
    return (one / (1.0 - torch.pow(_f32(cfg.b1, stepf), stepf)),
            one / (1.0 - torch.pow(_f32(cfg.b2, stepf), stepf)))


def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: AdamWConfig) -> tuple[dict, AdamWState]:
    """One AdamW step.  Returns (new_params, new_state)."""
    step = state.step + 1
    scale = clip_scale(cfg, grads)
    if scale is not None:
        grads = tree_map(lambda g: g * scale, grads)

    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v
                  + (1 - b2) * torch.square(g.to(torch.float32)),
                  state.nu, grads)
    mu_hat_scale, nu_hat_scale = bias_scales(cfg, step)
    lr = schedule(cfg, state.step)

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu)
