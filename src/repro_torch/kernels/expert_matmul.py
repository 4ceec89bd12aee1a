"""Grouped 2-bit ternary expert product: the plain PyTorch version and the
router.

`expert_matmul(x, w2, scale, offsets)` computes, for every expert e, rows
`offsets[e]:offsets[e + 1]` of x `(M, K)` (bf16 or f32, grouped by
expert) times expert e's codes `unpack(w2[e])`, times `scale[e]`: w2
`(E, K//4, N)` int8 packed as `core.ternary.pack_ternary` packs, scale
`(E, 1, N)` f32, offsets `(E + 1,)` int32 on x's device (0 to M,
non-decreasing); the result `(M, N)` f32.  The tensors' device picks the
executor: on the CPU the plain version below, a loop over the experts of
`ternary_matmul_plain` (the offsets read on the host); on a CUDA device
the hand-written grouped kernel (`cuda_expert_matmul`,
`csrc/expert_matmul.cu`), which reads the offsets on the device.  Nothing
falls back from one to the other.  Forward only, as the ternary matmul.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.ternary_matmul import X_DTYPES, ternary_matmul_plain


def per_expert(x: torch.Tensor, offsets: torch.Tensor, n_out: int,
               product: Callable[[torch.Tensor, int], torch.Tensor]
               ) -> torch.Tensor:
    """The plain loop over the experts: rows `offsets[e]:offsets[e + 1]`
    of x through `product(rows, e)` -> `(M, n_out)` f32 (the offsets read
    on the host)."""
    out = torch.zeros((x.shape[0], n_out), dtype=torch.float32,
                      device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = product(x[a:b], e)
    return out


def expert_matmul_plain(x: torch.Tensor, w2: torch.Tensor,
                        scale: torch.Tensor, offsets: torch.Tensor
                        ) -> torch.Tensor:
    """Each expert's rows through `ternary_matmul_plain` -> `(M, N)` f32."""
    return per_expert(x, offsets, w2.shape[2], lambda xe, e:
                      ternary_matmul_plain(xe, w2[e], scale[e]))


def check_operands(x: torch.Tensor, w2: torch.Tensor, scale: torch.Tensor,
                   offsets: torch.Tensor) -> tuple[int, int, int, int]:
    """Device, dtype, shape and contiguity checks; returns `(M, K, N, E)`.
    The offsets' values are not read here (that would wait for the card);
    the caller builds them non-decreasing from 0 to M."""
    for name, t in (("x", x), ("w2", w2), ("scale", scale),
                    ("offsets", offsets)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w2.dtype != torch.int8 or scale.dtype != torch.float32 \
            or offsets.dtype != torch.int32:
        raise TypeError(f"w2, scale and offsets must be int8, float32 and "
                        f"int32, got {w2.dtype}, {scale.dtype}, "
                        f"{offsets.dtype}")
    if x.dim() != 2 or w2.dim() != 3:
        raise ValueError(f"x must be (M, K) and w2 (E, K//4, N), got "
                         f"{tuple(x.shape)} and {tuple(w2.shape)}")
    M, K = x.shape
    E, K4, N = w2.shape
    if K % 4 or K4 * 4 != K:
        raise ValueError(f"x has K={K} but w2 holds {K4} packed rows")
    if tuple(scale.shape) != (E, 1, N):
        raise ValueError(f"scale must be ({E}, 1, {N}), got "
                         f"{tuple(scale.shape)}")
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"offsets must be ({E + 1},), got "
                         f"{tuple(offsets.shape)}")
    return M, K, N, E


def expert_matmul(x: torch.Tensor, w2: torch.Tensor, scale: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Grouped `(M, K) x (E, K//4, N)` packed ternary -> `(M, N)` f32, by
    device."""
    check_operands(x, w2, scale, offsets)
    if x.device.type == "cpu":
        return expert_matmul_plain(x, w2, scale, offsets)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad
                                        or scale.requires_grad):
            raise RuntimeError("the grouped expert kernel has no backward; "
                               "run under torch.inference_mode()")
        from repro_torch.kernels import cuda_expert_matmul
        return cuda_expert_matmul.launch(x, w2, scale, offsets)
    raise ValueError(f"no executor for device {x.device}")
