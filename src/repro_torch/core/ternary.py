"""Ternary and binary quantizers, the ABC input interface and 2-bit packing.

The port of `repro.core.ternary`.  The TNN's quantization-aware training
(`core.tnn.train_tnn`) uses the straight-through estimators: `ternarize`
maps latent weights to {-1, 0, +1} at a fixed threshold (1/3), compared in
float32 as the reference (JAX, no x64) compares; `ternary_ste` passes the
gradient where |w| <= 1, and `binary_step_ste` gives the hidden neurons'
{-1, +1} step a hard-tanh surrogate gradient.  Forward values are the
reference's float32 expressions op for op, and the backward masks equal
JAX's, half the gradient at an exact clip boundary included.

The LM codes are {-1, 0, +1} with a
per-output-channel scale alpha = mean|W| (BitNet-b1.58 style), stored four
to a byte along K:

    code 0b01 -> +1, 0b10 -> -1, 0b00 and 0b11 -> 0

Byte row `r` of a packed `(K//4, N)` int8 matrix holds K rows `4r..4r+3`
in bits 0-1, 2-3, 4-5 and 6-7.  `kernels/csrc/ternary_matmul.cu` reads the
same layout.

The ABC input interface of the TNN (Sec. 3.1) is here too: each feature's
comparator threshold V_q is the median of the normalized training
distribution (`abc_fit_thresholds`), and `abc_binarize` fires where the
reading exceeds it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

TERNARY_THRESHOLD = 1.0 / 3.0


def ternarize(w: torch.Tensor, threshold: float = TERNARY_THRESHOLD
              ) -> torch.Tensor:
    """Hard ternarization to {-1, 0, +1} in w's dtype (no gradient).

    The threshold is cast to w's dtype before the compare, as JAX casts a
    Python float, so a float32 latent between the two roundings of 1/3
    gets the reference's code.
    """
    thr = torch.full((), threshold, dtype=w.dtype, device=w.device)
    return torch.sign(w) * (w.abs() > thr).to(w.dtype)


def ternary_ste(w: torch.Tensor, threshold: float = TERNARY_THRESHOLD
                ) -> torch.Tensor:
    """Ternary forward, identity backward inside [-1, 1] (clipped STE)."""
    q = ternarize(w, threshold)
    wg = w * (w.abs() <= 1.0).to(w.dtype)
    return wg + (q - wg).detach()


def binary_step_ste(a: torch.Tensor, grad_width) -> torch.Tensor:
    """sign(a) in {-1, +1} with a >= 0 -> +1; hard-tanh surrogate gradient.

    Matches the hardware comparator semantics (sum >= 0 -> output 1).  The
    clip is `minimum(1, maximum(-1, a / grad_width))`, as `jnp.clip` is, so
    a value exactly on a boundary gets half the gradient as in JAX.
    """
    h = torch.where(a >= 0, 1.0, -1.0).to(a.dtype)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    surrogate = torch.minimum(one, torch.maximum(-one, a / grad_width))
    return surrogate + (h - surrogate).detach()


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
