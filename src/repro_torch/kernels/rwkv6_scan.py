"""RWKV-6 WKV recurrence: the plain PyTorch version and the router.

`rwkv6_scan(r, k, v, w, u, s0=None, s_out=None)` runs, per row (b, h) and
token t,

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

from `S_0 = s0` (zeros when not given), on operands in the model's own
layout: r, k, v, w `(B, T, H, dh)` views whose last dimension is
contiguous, heads `dh` apart and any step between batch rows and tokens;
r, k, v float32 or bfloat16 (all three alike), w float32; u float32,
`(H, dh)` (one bonus for every b) or `(B, H, dh)`; s0 `(B, H, dh, dh)`
float32.  It returns y `(B, T, H, dh)` and the final state `(B, H, dh,
dh)`, float32; with `s_out` (a contiguous `(B, H, dh, dh)` float32
tensor, which may be `s0` itself: the decode cache updated in place) the
final state is written there and `s_out` is returned.  The reference's
`(BH, T, dh)` layout, with u `(BH, dh)` and states `(BH, dh, dh)`, is the
case H = 1.

This is the function of the reference's sequential oracle
`ref.rwkv6_scan_ref` and of the recurrence in its model
(`models/ssm.py::rwkv6_timemix`).  The Pallas kernel
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

X_DTYPES = (torch.float32, torch.bfloat16)     # r, k, v


def _heads(r, k, v, w, u, s0, s_out):
    """`(BH, T, dh)` operands as the H = 1 case of `(B, T, H, dh)`."""
    return (*(a.unsqueeze(2) for a in (r, k, v, w)), u.unsqueeze(1),
            *(None if s is None else s.unsqueeze(1) for s in (s0, s_out)))


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None,
                     s_out: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence on the same views, in float32 (float64
    when w is, for a reference); returns `(y, final state)`.  The state
    is computed into a fresh tensor and copied into `s_out` last, so
    `s_out` may alias `s0`."""
    if r.dim() == 3:
        y, s = rwkv6_scan_plain(*_heads(r, k, v, w, u, s0, s_out))
        return y.squeeze(2), s.squeeze(1)
    dt = torch.promote_types(r.dtype, w.dtype)
    B, T, H, dh = r.shape
    S = torch.zeros((B, H, dh, dh), dtype=dt, device=r.device) \
        if s0 is None else s0.to(dt).clone()
    y = torch.empty((B, T, H, dh), dtype=dt, device=r.device)
    uu = u.to(dt)[..., :, None]
    for t in range(T):
        rt, kt, vt, wt = (a[:, t].to(dt) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]             # (B, H, dh, dh)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rt, S + uu * kv)
        S = wt[..., :, None] * S + kv
    if s_out is None:
        return y, S
    s_out.copy_(S)
    return y, s_out


def check_operands(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   s0: torch.Tensor | None,
                   s_out: torch.Tensor | None = None
                   ) -> tuple[int, int, int, int]:
    """Device, dtype, shape and layout checks on `(B, T, H, dh)` or
    `(BH, T, dh)` operands; returns `(B, T, H, dh)` (H = 1 for the
    latter).  It runs on every decode step of every layer, so it reads
    each attribute once."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0),
             ("s_out", s_out))
    dev, xdt = r.device, r.dtype
    for name, t in named:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
        if name in ("r", "k", "v"):
            if t.dtype != xdt or xdt not in X_DTYPES:
                raise TypeError(f"{name} must be torch.float32 or "
                                f"torch.bfloat16 like r, got {t.dtype}")
        elif t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    shape = r.shape
    if len(shape) not in (3, 4):
        raise ValueError(f"r must be (B, T, H, dh) or (BH, T, dh), got "
                         f"{tuple(shape)}")
    for name, t in named[1:4]:
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{tuple(shape)}")
    if len(shape) == 3:
        B, T, dh = shape
        H = 1
        u_shapes, s_shape = ((B, dh),), (B, dh, dh)
    else:
        B, T, H, dh = shape
        u_shapes, s_shape = ((H, dh), (B, H, dh)), (B, H, dh, dh)
    if r.numel():                       # an empty operand reads nothing
        for name, t in named[:4]:
            st = t.stride()
            if dh > 1 and st[-1] != 1:
                raise ValueError(f"{name}'s last dimension must be "
                                 "contiguous")
            if len(st) == 4 and H > 1 and st[2] != dh:
                raise ValueError(f"{name}'s heads must lie dh = {dh} "
                                 f"elements apart, got a step of {st[2]}")
    if u.shape not in u_shapes:
        raise ValueError(f"u must be {' or '.join(map(str, u_shapes))}, "
                         f"got {tuple(u.shape)}")
    for name, t in named[4:]:
        if t is None:
            continue
        if name != "u" and t.shape != s_shape:
            raise ValueError(f"{name} must be {s_shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, T, H, dh


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None,
               s_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over `(B, T, H, dh)` or `(BH, T, dh)` operands ->
    `(y, final state)`, by device."""
    check_operands(r, k, v, w, u, s0, s_out)
    if r.dim() == 3:
        y, s = rwkv6_scan(*_heads(r, k, v, w, u, s0, s_out))
        return y.squeeze(2), s.squeeze(1)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0, s_out)
    if r.device.type == "cuda":
        from repro_torch.kernels import cuda_rwkv6_scan
        return cuda_rwkv6_scan.launch(r, k, v, w, u, s0, s_out)
    raise ValueError(f"no executor for device {r.device}")
