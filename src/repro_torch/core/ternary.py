"""Ternary weights for LM layers: absmean quantizer and 2-bit packing.

The LM half of `repro.core.ternary`.  Codes are {-1, 0, +1} with a
per-output-channel scale alpha = mean|W| (BitNet-b1.58 style), stored four
to a byte along K:

    code 0b01 -> +1, 0b10 -> -1, 0b00 and 0b11 -> 0

Byte row `r` of a packed `(K//4, N)` int8 matrix holds K rows `4r..4r+3`
in bits 0-1, 2-3, 4-5 and 6-7.  `kernels/csrc/ternary_matmul.cu` reads the
same layout.  The TNN STE quantizers and `abc_binarize` come with the
campaign slice.
"""
from __future__ import annotations

import torch


def ternary_quantize_lm(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmean ternarization: `(codes in {-1,0,1}, alpha)`, W ~= alpha*codes.

    alpha is the mean of |w| over every axis but the last, plus 1e-8, kept
    as `(1, ..., N)`.  So call it on one 2-D `(K, N)` matrix per layer,
    never on an `(L, K, N)` stack: a stack would share one alpha across all
    L layers.  Codes have w's dtype.
    """
    alpha = w.abs().mean(dim=tuple(range(w.ndim - 1)), keepdim=True) + 1e-8
    codes = torch.clamp(torch.round(w / alpha), -1, 1)
    return codes, alpha


def pack_ternary(codes: torch.Tensor) -> torch.Tensor:
    """Pack {-1,0,1} codes `(K, N...)` into `(K//4, N...)` int8."""
    K = codes.shape[0]
    if K % 4:
        raise ValueError(f"K={K} not a multiple of 4")
    u = torch.where(codes > 0, 1, torch.where(codes < 0, 2, 0)).to(torch.uint8)
    u = u.reshape(K // 4, 4, *codes.shape[1:])
    packed = u[:, 0] | (u[:, 1] << 2) | (u[:, 2] << 4) | (u[:, 3] << 6)
    return packed.view(torch.int8)


def unpack_ternary(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of `pack_ternary`: `(K//4, N...)` int8 -> `(K, N...)` dtype."""
    u = packed.view(torch.uint8)
    st = torch.stack([(u >> (2 * i)) & 0x3 for i in range(4)], dim=1)
    vals = (st == 1).to(dtype) - (st == 2).to(dtype)
    return vals.reshape(-1, *packed.shape[1:])


def zero_fraction(codes: torch.Tensor) -> torch.Tensor:
    """Share of zero codes: the sparsity that removes wires in print."""
    return (codes == 0).float().mean()
