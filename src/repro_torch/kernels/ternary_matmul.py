"""2-bit packed ternary matmul: the plain PyTorch version and the router.

`ternary_matmul(x, w2, scale)` computes `(x @ unpack(w2)) * scale` in f32:
x `(M, K)` bf16 or f32, w2 `(K//4, N)` int8 holding four 2-bit codes per
byte along K (`core.ternary`), scale `(1, N)` f32, result `(M, N)` f32.
The tensors' device picks the executor: on the CPU the plain version
below, on a CUDA device the hand-written kernel
(`cuda_ternary_matmul`, `csrc/ternary_matmul.cu`); on the `meta` device
the card path's output, shape and dtype only, with the call reported to
the costing (`kernels.meta`).  Nothing falls back from one to another.
Both apply the scale after the sum, as the Pallas kernel
`repro/kernels/ternary_matmul.py` and `ref.ternary_matmul_ref` do.

The kernel is forward-only, as the Pallas kernel is: on a CUDA (or meta)
tensor the router raises when autograd would need a gradient through it
(grad mode on and x or scale requiring one).  The reference trains `"dense"`
and `"ternary"` (a dense product with a straight-through quantizer),
never `"ternary_packed"`; serving runs under `torch.inference_mode`.
"""
from __future__ import annotations

import torch

from repro_torch.core.ternary import unpack_ternary

X_DTYPES = (torch.float32, torch.bfloat16)


def ternary_matmul_plain(x: torch.Tensor, w2: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """`(x.float() @ unpack(w2).float()) * scale.float()` -> `(M, N)` f32."""
    w = unpack_ternary(w2, dtype=torch.float32)
    return (x.float() @ w) * scale.float()


def check_operands(x: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor) -> tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks; returns `(M, K, N)`."""
    for name, t in (("x", x), ("w2", w2), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w2.dtype != torch.int8:
        raise TypeError(f"w2 must be int8, got {w2.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"x must be (M, K) and w2 (K//4, N), got "
                         f"{tuple(x.shape)} and {tuple(w2.shape)}")
    M, K = x.shape
    K4, N = w2.shape
    if K % 4 or K4 * 4 != K:
        raise ValueError(f"x has K={K} but w2 holds {K4} packed rows "
                         f"(K must be 4 * w2.shape[0])")
    if tuple(scale.shape) != (1, N):
        raise ValueError(f"scale must be (1, {N}), got {tuple(scale.shape)}")
    return M, K, N


def ternary_matmul(x: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """`(M, K) x (K//4, N)` packed ternary -> `(M, N)` f32, by device."""
    check_operands(x, w2, scale)
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, w2, scale)
    if x.device.type in ("cuda", "meta"):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or scale.requires_grad):
            raise RuntimeError(
                "the ternary matmul kernel has no backward: a packed "
                "ternary projection cannot be trained; train with "
                "quant='ternary' (straight-through) or run under "
                "torch.no_grad() / torch.inference_mode()")
        if x.device.type == "meta":
            from repro_torch.kernels import meta
            return meta.ternary_matmul(x, w2, scale)
        from repro_torch.kernels import cuda_ternary_matmul
        return cuda_ternary_matmul.launch(x, w2, scale)
    raise ValueError(f"no executor for device {x.device}")
