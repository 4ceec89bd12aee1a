"""Int8 error-feedback gradient compression and block-wise int8 AdamW.

Compression, a leaf at a time: g' = g + e; scale = max|g'| / 127 +
1e-12; the optimizer gets round(g' / scale) * scale (codes clipped to
[-127, 127]) and e becomes g' minus that.

AdamW with int8 moments: m and v are kept as int8 codes with a float32
scale for every 512 values along the last axis (max|x| / 127 + 1e-12,
codes round(x / scale), half to even).  A step clips the gradients to
global norm `clip` (divisor norm + 1e-9), forms m = b1 m + (1 - b1) g and
v = b2 v + (1 - b2) g^2 from the stored moments, floors v at b2 times half
its stored block's step in the update only, and sets p = p - lr * (m /
(1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), stored in the parameter's
dtype; the new moments are stored quantized.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 512
B1, B2, EPS = 0.9, 0.999, 1e-8


def compress(g: torch.Tensor, e: torch.Tensor):
    """(the gradient the optimizer gets, the new error)."""
    g = g.float() + e
    scale = g.abs().max() / 127.0 + 1e-12
    deq = torch.clamp(torch.round(g / scale), -127, 127) * scale
    return deq, g - deq


def _blocks(x: torch.Tensor):
    *lead, last = x.shape
    nb = -(-last // BLOCK)
    return F.pad(x, (0, nb * BLOCK - last)).reshape(*lead, nb, BLOCK), last


def quantize(x: torch.Tensor):
    """(int8 codes in blocks, scales, length of the last axis) of the
    block-wise int8 moment."""
    blocks, last = _blocks(x.float())
    scales = blocks.abs().amax(-1) / 127.0 + 1e-12
    codes = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
    return codes.to(torch.int8), scales, last


def dequantize(q) -> torch.Tensor:
    codes, scales, last = q
    x = codes.float() * scales[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :last]


def half_step(q) -> torch.Tensor:
    codes, scales, last = q
    h = (scales * 0.5)[..., None].expand(codes.shape)
    return h.reshape(*h.shape[:-2], -1)[..., :last]


def zeros_like_moment(p: torch.Tensor):
    return quantize(torch.zeros(p.shape, device=p.device))


def adamw_step(params: dict, grads: dict, mu: dict, nu: dict, t: int,
               lr: float, clip: float | None):
    """One step over flat dicts of leaves (same keys): returns (params,
    mu, nu), params in their stored dtype."""
    if clip is not None:
        norm = torch.sqrt(sum(torch.sum(g.float().square())
                              for g in grads.values()))
        cs = torch.clamp(clip / (norm + 1e-9), max=1.0)
        grads = {k: g.float() * cs for k, g in grads.items()}
    mh = 1.0 / (1.0 - B1 ** t)
    vh = 1.0 / (1.0 - B2 ** t)
    out_p, out_m, out_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = B1 * dequantize(mu[k]) + (1 - B1) * g
        v = B2 * dequantize(nu[k]) + (1 - B2) * g.square()
        vf = torch.maximum(v, B2 * half_step(nu[k]))
        u = (m * mh) / (torch.sqrt(vf * vh) + EPS)
        out_p[k] = (p.float() - lr * u).to(p.dtype)
        out_m[k], out_v[k] = quantize(m), quantize(v)
    return out_p, out_m, out_v
