"""RWKV-6 WKV recurrence: the plain PyTorch version and the router.

`rwkv6_scan(r, k, v, w, u, s0=None)` runs, per batch-head row and token t,

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

from `S_0 = s0` (zeros when not given): r, k, v, w `(BH, T, dh)`, u
`(BH, dh)`, s0 `(BH, dh, dh)`, all float32; it returns y `(BH, T, dh)` and
the final state `(BH, dh, dh)`, float32.  This is the function of the
reference's sequential oracle `ref.rwkv6_scan_ref` and of the recurrence
in its model (`models/ssm.py::rwkv6_timemix`).  The Pallas kernel
`repro/kernels/rwkv6_scan.py` computes it in a chunked matmul form that
divides by the cumulative decay and holds only for decays `w ≳ 0.6`; both
versions here run the recurrence token by token and hold at any decay in
(0, 1).

The tensors' device picks the executor: on the CPU the plain version
below, on a CUDA device the hand-written kernel (`cuda_rwkv6_scan`,
`csrc/rwkv6_scan.cu`); nothing falls back from one to the other.
"""
from __future__ import annotations

import torch


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence in the operands' dtype (float32, or
    float64 for a reference); returns `(y, final state)`."""
    BH, T, dh = r.shape
    S = torch.zeros((BH, dh, dh), dtype=r.dtype, device=r.device) \
        if s0 is None else s0.clone()
    y = torch.empty_like(r)
    uu = u[:, :, None]
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]            # (BH, dh, dh)
        y[:, t] = torch.einsum("bk,bkv->bv", r[:, t], S + uu * kv)
        S = w[:, t, :, None] * S + kv
    return y, S


def check_operands(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   s0: torch.Tensor | None) -> tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks; returns `(BH, T, dh)`."""
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, T, dh), got {tuple(r.shape)}")
    BH, T, dh = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (BH, dh):
        raise ValueError(f"u must be ({BH}, {dh}), got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (BH, dh, dh):
        raise ValueError(f"s0 must be ({BH}, {dh}, {dh}), got "
                         f"{tuple(s0.shape)}")
    return BH, T, dh


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over `(BH, T, dh)` float32 operands -> `(y, final state)`,
    by device."""
    check_operands(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0)
    if r.device.type == "cuda":
        from repro_torch.kernels import cuda_rwkv6_scan
        return cuda_rwkv6_scan.launch(r, k, v, w, u, s0)
    raise ValueError(f"no executor for device {r.device}")
