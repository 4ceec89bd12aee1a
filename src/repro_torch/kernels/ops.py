"""Public kernel entry points that model code calls, with the reference's
signatures (`repro/kernels/ops.py`).

`ternary_matmul` takes activations of any leading shape; the kernel
wrapper below it takes `(M, K)`.  `rwkv6_scan` also takes an initial
state `s0`, which the reference's kernel lacks and the model's decode
needs; `rwkv6_scan_heads` is the same recurrence on the model's own
`(B, T, H, dh)` views, with the final state written in place where the
caller asks.  Each entry point runs by the device of its tensors: the
plain PyTorch version on the CPU, the hand-written kernel on a CUDA
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import expert_matmul as EM
from repro_torch.kernels import packed_popcount as PP
from repro_torch.kernels import rwkv6_scan as WKV
from repro_torch.kernels import ternary_matmul as TM


def ternary_matmul(x: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """`(..., K)` x packed `(K//4, N)` ternary -> `(..., N)` f32."""
    lead = x.shape[:-1]
    y = TM.ternary_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w2, scale)
    return y.reshape(*lead, w2.shape[1])


def expert_matmul(x: torch.Tensor, w2: torch.Tensor, scale: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Rows of `(M, K)` x grouped by expert (`offsets` `(E + 1,)` int32)
    times each expert's packed `(E, K//4, N)` ternary codes and `(E, 1,
    N)` scale -> `(M, N)` f32 (the port's own entry: the reference has no
    grouped product)."""
    return EM.expert_matmul(x, w2, scale, offsets)


def packed_popcount(words: torch.Tensor) -> torch.Tensor:
    """`(B, W)` int32 bit-pattern words -> `(B,)` int32 popcounts."""
    return PP.packed_popcount(words)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, chunk: int = 32,
               s0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6: `(BH, T, dh)` x4 + u `(BH, dh)` [+ s0 `(BH, dh, dh)`] ->
    `(y, final state)`, float32.

    `chunk` is the reference kernel's chunk length.  Both versions here
    run the recurrence token by token, so it does not change the result;
    it is checked and otherwise unused, and `T` need not be a multiple of
    it.  Operands are taken to float32, as the reference's oracle does.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    r, k, v, w, u = (t.float().contiguous() for t in (r, k, v, w, u))
    if s0 is not None:
        s0 = s0.float().contiguous()
    return WKV.rwkv6_scan(r, k, v, w, u, s0)


def rwkv6_scan_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None,
                     s_out: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 on the model's layout: r, k, v `(B, T, H, dh)` views in
    float32 or bfloat16, w the same in float32, u `(H, dh)` [+ s0
    `(B, H, dh, dh)`] -> `(y (B, T, H, dh), final state (B, H, dh, dh))`,
    float32.  With `s_out` the final state is written there; it may be
    `s0` (the decode cache updated in place)."""
    return WKV.rwkv6_scan(r, k, v, w, u, s0, s_out)
