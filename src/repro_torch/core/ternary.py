"""Ternary weights for LM layers: absmean quantizer and 2-bit packing.

The LM half of `repro.core.ternary`.  Codes are {-1, 0, +1} with a
per-output-channel scale alpha = mean|W| (BitNet-b1.58 style), stored four
to a byte along K:

    code 0b01 -> +1, 0b10 -> -1, 0b00 and 0b11 -> 0

Byte row `r` of a packed `(K//4, N)` int8 matrix holds K rows `4r..4r+3`
in bits 0-1, 2-3, 4-5 and 6-7.  `kernels/csrc/ternary_matmul.cu` reads the
same layout.

The ABC input interface of the TNN (Sec. 3.1) is here too: each feature's
comparator threshold V_q is the median of the normalized training
distribution (`abc_fit_thresholds`), and `abc_binarize` fires where the
reading exceeds it.  The STE quantizers of QAT come with the trainer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


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


def abc_fit_thresholds(x_train: np.ndarray) -> np.ndarray:
    """Per-feature V_q = median of the normalized training distribution.

    In hardware, V_q is realized by the R1/R2 divider ratio of each ABC.
    """
    return np.median(x_train, axis=0)


def abc_binarize(x, thresholds, device=None) -> torch.Tensor:
    """Comparator output: 1.0 where the sensor reading exceeds V_q.

    `(N, F)` readings against `(F,)` thresholds, numpy arrays or tensors,
    compared in float32 as the reference (JAX, no x64) compares, on
    `device` (None: the current CUDA device).  Returns `(N, F)` float32 on
    that device.
    """
    dev = resolve_device(device)
    x, thr = (torch.as_tensor(a).to(device=dev, dtype=torch.float32)
              for a in (x, thresholds))
    return (x > thr[None, :]).to(torch.float32)
