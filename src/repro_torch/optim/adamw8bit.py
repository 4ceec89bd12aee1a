"""Block-wise int8 AdamW moments (8-bit-optimizer style).

The port of `repro.optim.adamw8bit`.  The moments m and v are stored as
int8 codes with a float32 absmax scale for every `BLOCK` values along the
last axis, about a quarter of f32 moments' memory.  The codes keep the
parameter's shape (a 0-d parameter's are `(1,)`, as in the reference); the
scales are `shape[:-1] + (ceil(last / BLOCK),)`.  Quantization: a block's
scale is `max|x| / 127 + 1e-12`, its codes `round(x / scale)` (half to
even) clipped to [-127, 127].

One step, in the reference's order: the global-norm clip (epsilon 1e-9),
the moments from the dequantized ones, the float32 bias corrections, the
update `m_hat / (sqrt(v_hat) + eps)` plus weight decay, then the new
moments quantized.

One departure, where the reference's update is undefined in practice: a
second-moment entry below half its block's step stores the code 0 and
dequantizes to 0, while its first moment, stored on its own linear scale,
does not; when the next gradient of that entry is 0 too (int8 gradient
compression rounds most small entries to 0) the reference divides m_hat
by eps = 1e-8 and the parameter jumps by ~1e8 lr m_hat
(`repro/optim/adamw8bit.py:97-99`).  The port's update
divides by at least what such a code may hold: v is floored at `b2` times
half the stored block's step (`_half_step`) in the update only.  An entry
whose stored code is not 0 has v above that floor, so its update is the
reference's; the stored moments are the reference's in every entry.

Every quotient divides by a tensor on the moments' device, as
`optim.adamw` explains.  Parameters and gradients are nested dicts of
tensors; the moments are nested dicts of `Q8Tensor`s like them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import (AdamWConfig, _f32, bias_scales,
                                     clip_scale, schedule, tree_leaves,
                                     tree_map)

BLOCK = 512


class Q8Tensor(NamedTuple):
    codes: torch.Tensor      # int8, the parameter's shape
    scales: torch.Tensor     # f32, shape[:-1] + (n_blocks,)


class AdamW8bitState(NamedTuple):
    step: torch.Tensor       # scalar int32
    mu: dict                 # nested dict of Q8Tensor, like params
    nu: dict


def _nblocks(last: int) -> int:
    return -(-last // BLOCK)


def _quantize(x: torch.Tensor) -> Q8Tensor:
    *lead, last = x.shape
    nb = _nblocks(last)
    blocks = F.pad(x, (0, nb * BLOCK - last)).reshape(*lead, nb, BLOCK)
    scales = blocks.abs().amax(dim=-1) / _f32(127.0, x) + 1e-12
    codes = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
    codes = codes.reshape(*lead, nb * BLOCK)[..., :last].to(torch.int8)
    return Q8Tensor(codes, scales)


def _dequantize(q: Q8Tensor) -> torch.Tensor:
    *lead, last = q.codes.shape
    nb = q.scales.shape[-1]
    cp = F.pad(q.codes.to(torch.float32), (0, nb * BLOCK - last))
    blocks = cp.reshape(*lead, nb, BLOCK) * q.scales[..., None]
    return blocks.reshape(*lead, nb * BLOCK)[..., :last]


def _half_step(q: Q8Tensor) -> torch.Tensor:
    """Half of each block's quantization step, the largest value a code of
    0 stands for, broadcast to the codes' shape."""
    *lead, last = q.codes.shape
    nb = q.scales.shape[-1]
    half = (q.scales * 0.5)[..., None].expand(*lead, nb, BLOCK)
    return half.reshape(*lead, nb * BLOCK)[..., :last]


def _shape(p: torch.Tensor) -> tuple[int, ...]:
    return tuple(p.shape) if p.dim() > 0 else (1,)


def init(params: dict) -> AdamW8bitState:
    def zq(p):
        return _quantize(torch.zeros(_shape(p), dtype=torch.float32,
                                     device=p.device))

    dev = tree_leaves(params)[0].device
    return AdamW8bitState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zq, params), nu=tree_map(zq, params))


def state_from_arrays(step, mu: dict, nu: dict, device) -> AdamW8bitState:
    """An `AdamW8bitState` from the reference's state as numpy arrays (the
    step count and nested dicts of `(codes, scales)` pairs, such as the
    reference's `Q8Tensor`s), placed on `device`."""
    def q8(pair):
        codes, scales = (torch.as_tensor(np.array(a)) for a in pair)
        return Q8Tensor(codes.to(device=device, dtype=torch.int8),
                        scales.to(device=device, dtype=torch.float32))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else q8(v)
                for k, v in tree.items()}

    return AdamW8bitState(
        step=torch.as_tensor(step).to(device=device, dtype=torch.int32),
        mu=walk(mu), nu=walk(nu))


def apply_updates(params: dict, grads: dict, state: AdamW8bitState,
                  cfg: AdamWConfig) -> tuple[dict, AdamW8bitState]:
    """One step.  Returns (new_params, new_state)."""
    step = state.step + 1
    cscale = clip_scale(cfg, grads)
    if cscale is not None:
        grads = tree_map(lambda g: g * cscale, grads)
    b1, b2 = cfg.b1, cfg.b2
    mu_hat_scale, nu_hat_scale = bias_scales(cfg, step)
    lr = schedule(cfg, state.step)

    def one(p, g, mq, vq):
        shape = _shape(p)
        g32 = g.to(torch.float32).reshape(shape)
        m = b1 * _dequantize(mq) + (1 - b1) * g32
        v = b2 * _dequantize(vq) + (1 - b2) * torch.square(g32)
        v_floor = torch.maximum(v, b2 * _half_step(vq))
        u = (m * mu_hat_scale) / (torch.sqrt(v_floor * nu_hat_scale)
                                  + cfg.eps)
        p32 = p.to(torch.float32).reshape(shape)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p32
        newp = (p32 - lr * u).to(p.dtype).reshape(p.shape)
        return newp, _quantize(m), _quantize(v)

    out = tree_map(one, params, grads, state.mu, state.nu)
    pick = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    return pick[0], AdamW8bitState(step=step, mu=pick[1], nu=pick[2])
