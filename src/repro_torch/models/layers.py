"""Shared model layers: norms, rotary embeddings, embedding, linears.

The port of `repro.models.layers`.  Every projection supports the three
quantization modes of the config:

  * "dense"          — `x @ w`;
  * "ternary"        — the forward value of absmean ternary QAT,
                       `x @ (codes * alpha)` (its STE gradient comes with
                       the training slice);
  * "ternary_packed" — serving: 2-bit codes (four per int8 byte) and a
                       per-column scale, multiplied by
                       `kernels.ops.ternary_matmul`, which on the card is
                       the hand-written kernel.

`mrope_cos_sin` is Qwen2-VL's multimodal RoPE.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ternary import ternary_quantize_lm
from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def linear(p: dict, x: torch.Tensor, quant: str = "dense") -> torch.Tensor:
    """p holds {"w": (K, N)} [+ "b"] or packed {"w2": (K//4, N),
    "scale": (1, N)} [+ "b"]."""
    if quant == "ternary_packed":
        y = ops.ternary_matmul(x, p["w2"], p["scale"]).to(x.dtype)
    elif quant == "ternary":
        codes, alpha = ternary_quantize_lm(p["w"])
        y = x @ (codes * alpha).to(x.dtype)
    elif quant == "dense":
        y = x @ p["w"].to(x.dtype)
    else:
        raise ValueError(f"unknown quant mode {quant!r}")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, d_head//2) f32."""
    freqs = torch.from_numpy(_rope_freqs(d_head, theta)).to(positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh); cos/sin: (B, S, dh//2) (broadcast over heads)."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def mrope_cos_sin(positions: torch.Tensor, d_head: int, theta: float,
                  sections: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): positions (B, 3, S) carry the (t, h, w)
    ids.  The dh//2 frequencies are split into `sections` (summing to
    dh//2); each section takes its angle from its own position stream.
    Returns cos/sin (B, S, dh//2) f32."""
    if sum(sections) != d_head // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"d_head // 2 = {d_head // 2}")
    freqs = torch.from_numpy(_rope_freqs(d_head, theta)).to(positions.device)
    ang_all = positions.float()[..., None] * freqs        # (B, 3, S, dh//2)
    parts, start = [], 0
    for si, sec in enumerate(sections):
        parts.append(ang_all[:, si, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                        # (B, S, dh//2)
    return torch.cos(ang), torch.sin(ang)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)


def lm_head(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ table.float()
