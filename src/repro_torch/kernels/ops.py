"""Public kernel entry points that model code calls.

`ternary_matmul` takes activations of any leading shape; the kernel
wrapper below it takes `(M, K)`.  `packed_popcount` and `rwkv6_scan` join
with the slice that runs them (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ternary_matmul as TM


def ternary_matmul(x: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """`(..., K)` x packed `(K//4, N)` ternary -> `(..., N)` f32."""
    lead = x.shape[:-1]
    y = TM.ternary_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w2, scale)
    return y.reshape(*lead, w2.shape[1])
