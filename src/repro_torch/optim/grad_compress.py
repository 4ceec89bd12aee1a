"""Error-feedback int8 gradient compression.

The port of `repro.optim.grad_compress`.  Each gradient tensor is
quantized to int8 with one per-tensor scale `max|g| / 127 + 1e-12`, and
the quantization residual is kept in an error buffer that is added back
the next step, so over steps the compression is unbiased.  As in the
reference, compression is expressed as quantize -> dequantize around the
gradient (on one device there is no all-reduce to shrink; the optimizer
sees the dequantized gradient either way).  Gradients and the error
buffer are nested dicts of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _f32, tree_map


def init_error_buffer(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / _f32(127.0, g) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: dict, err: dict) -> tuple[dict, dict]:
    """Returns (dequantized grads to feed the optimizer, new error
    buffer)."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = _q8(g32)
        deq = q.to(torch.float32) * scale
        return deq, g32 - deq

    out = tree_map(one, grads, err)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))
