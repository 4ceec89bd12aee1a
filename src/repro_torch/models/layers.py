"""Shared model layers: norms, rotary embeddings, embedding, linears.

The port of `repro.models.layers`.  Every projection supports the three
quantization modes of the config:

  * "dense"          — `x @ w`;
  * "ternary"        — absmean ternary QAT, `x @ ternary_ste_lm(w)`:
                       the value `x @ (codes * alpha)`, the gradient of
                       the dense product (straight-through);
  * "ternary_packed" — serving: 2-bit codes (four per int8 byte) and a
                       per-column scale, multiplied by
                       `kernels.ops.ternary_matmul`, which on the card is
                       the hand-written kernel.

`mrope_cos_sin` is Qwen2-VL's multimodal RoPE; `rope_spec_cos_sin` the
rope of one layer kind (`configs.base.RopeSpec`: default, or YaRN by the
formula of HF transformers' `_compute_yarn_parameters`), its angles taken
in float64.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.ternary import ternary_ste_lm
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
        y = x @ ternary_ste_lm(p["w"]).to(x.dtype)
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


def rope_inv_freq(d_head: int, spec) -> tuple[np.ndarray, float]:
    """`(inverse frequencies (d_head // 2,) float64, attention factor)` of
    a `RopeSpec`.  Default: theta^(-2i/dh), factor 1.  YaRN: the
    correction dims of `beta_fast` and `beta_slow` rotations over the
    original context, dh ln(orig / (2 pi beta)) / (2 ln theta), floored
    and ceiled and clamped to [0, dh - 1]; a linear ramp between them
    over the dh / 2 frequency indices blends each frequency from
    extrapolated (theta^(-2i/dh), below the low dim) to interpolated
    (that over `factor`, above the high dim); the attention factor is
    `attention_factor`, or 0.1 ln(factor) + 1 when it is None."""
    base = spec.theta
    pos_freqs = base ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head)
    if spec.rope_type == "default":
        return 1.0 / pos_freqs, 1.0
    if spec.rope_type != "yarn":
        raise ValueError(f"unknown rope type {spec.rope_type!r}; use "
                         "'default' or 'yarn'")
    factor, orig = spec.factor, spec.original_max_position_embeddings
    af = spec.attention_factor
    if af is None:
        af = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0

    def dim(rotations: float) -> float:
        return d_head * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(dim(spec.beta_fast)), 0)
    high = min(math.ceil(dim(spec.beta_slow)), d_head - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(d_head // 2) - low) / (high - low), 0.0, 1.0)
    inv = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1 - ramp)
    return inv, float(af)


@functools.lru_cache(maxsize=64)
def _inv_freq_on(d_head: int, spec, device: torch.device):
    inv, af = rope_inv_freq(d_head, spec)
    return torch.from_numpy(inv).to(device), af


def rope_spec_cos_sin(positions: torch.Tensor, d_head: int, spec
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, d_head//2) f32 of a
    `RopeSpec`: angles in float64, both tables times its attention
    factor."""
    inv, af = _inv_freq_on(d_head, spec, positions.device)
    ang = positions.double()[..., None] * inv
    return (torch.cos(ang) * af).float(), (torch.sin(ang) * af).float()


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
