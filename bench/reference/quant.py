"""The ternary quantizer, frozen: absmean codes of a `(K, N)` matrix.

alpha is the mean of |w| over K for each output column, plus 1e-8; the
codes are round(w / alpha) clipped to {-1, 0, +1} (round half to even).
The served product is `(x @ codes) * alpha`.
"""
from __future__ import annotations

import torch


def ternary(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`(codes, alpha)` of one layer's `(K, N)` weights, in float32:
    codes `(K, N)`, alpha `(1, N)`."""
    w = w.float()
    alpha = w.abs().mean(dim=0, keepdim=True) + 1e-8
    return torch.clamp(torch.round(w / alpha), -1, 1), alpha
