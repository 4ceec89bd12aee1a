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
`csrc/rwkv6_scan.cu`), on the `meta` device the card path's outputs
(shapes and dtypes), with the call reported
to the costing (`kernels.meta`); nothing falls back from one to another.

Gradients.  Where autograd records (grad mode on and an operand needing
a gradient) the router runs `WKVScan`, a `torch.autograd.Function`: its
forward is the same executor, which also keeps the state every `CK`
tokens (`(B, H, ceil(T / CK), dh, dh)`, the state before tokens 0, CK,
2 CK, ...), and its backward walks the sequence in reverse, chunk by
chunk: the chunk's states are recomputed forward from its checkpoint,
then, with G_T = dL/dS_T (zeros when the final state carries no
gradient), for t = T .. 1

    dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    du[i]  += r_t[i] k_t[i] sum_j dy_t[j] v_t[j]
    dk_t[i] = sum_j (r_t[i] u[i] dy_t[j] + G_t[i,j]) v_t[j]
    dv_t[j] = sum_i (r_t[i] u[i] dy_t[j] + G_t[i,j]) k_t[i]
    dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
    G_{t-1}[i,j] = w_t[i] G_t[i,j] + r_t[i] dy_t[j]

and ds0 = G_0.  Nothing divides by the decay.  On the CPU the backward is
`rwkv6_scan_bwd_plain`, on the card the hand-written backward kernel
(`cuda_rwkv6_scan.launch_bwd`).  The reference has no backward kernel:
JAX differentiates its `lax.scan`.  An in-place `s_out` (the decode
cache) is refused under autograd.  On the CPU float64 operands (all of
them) run the plain version in float64, for `gradcheck`.
"""
from __future__ import annotations

import torch

X_DTYPES = (torch.float32, torch.bfloat16)     # r, k, v
CK = 16     # tokens between the state checkpoints a gradient run keeps


def n_checkpoints(T: int) -> int:
    """States a gradient run keeps for T tokens: ceil(T / CK)."""
    return -(-T // CK)


def _heads(r, k, v, w, u, s0, s_out):
    """`(BH, T, dh)` operands as the H = 1 case of `(B, T, H, dh)`."""
    return (*(a.unsqueeze(2) for a in (r, k, v, w)), u.unsqueeze(1),
            *(None if s is None else s.unsqueeze(1) for s in (s0, s_out)))


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None,
                     s_out: torch.Tensor | None = None,
                     ckpt: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence on the same views, in float32 (float64
    when w is, for a reference); returns `(y, final state)`.  The state
    is computed into a fresh tensor and copied into `s_out` last, so
    `s_out` may alias `s0`.  With `ckpt` (`(B, H, n_checkpoints(T), dh,
    dh)`, 4-D operands only) the state before every CK-th token is
    written there."""
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
        if ckpt is not None and t % CK == 0:
            ckpt[:, :, t // CK] = S
        rt, kt, vt, wt = (a[:, t].to(dt) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]             # (B, H, dh, dh)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rt, S + uu * kv)
        S = wt[..., :, None] * S + kv
    if s_out is None:
        return y, S
    s_out.copy_(S)
    return y, s_out


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         ckpt: torch.Tensor, dy: torch.Tensor,
                         ds: torch.Tensor | None = None) -> tuple:
    """The reverse recurrence (see the module docstring) on `(B, T, H,
    dh)` operands, from the forward's checkpoints `ckpt`, the output
    gradient `dy` and the final state's `ds` (None: zeros), in float32
    (float64 when w is).  Returns `(dr, dk, dv, dw, du_rows, ds0)`: dr,
    dk, dv in r's dtype, dw in w's, `du_rows` `(B, H, dh)` the bonus
    gradient of each row (the caller sums it over b for a shared
    bonus), ds0 `(B, H, dh, dh)`."""
    dt = torch.promote_types(r.dtype, w.dtype)
    B, T, H, dh = r.shape
    G = torch.zeros((B, H, dh, dh), dtype=dt, device=r.device) \
        if ds is None else ds.to(dt).clone()
    uu = u.to(dt).expand(B, H, dh)
    grads = [torch.empty((B, T, H, dh), dtype=dt, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((B, H, dh), dtype=dt, device=r.device)
    for c in reversed(range(n_checkpoints(T))):
        t0, t1 = c * CK, min(T, (c + 1) * CK)
        S = ckpt[:, :, c].to(dt)
        prev = []                     # S_{t-1} for t in the chunk
        for t in range(t0, t1):
            prev.append(S)
            kt, vt, wt = (a[:, t].to(dt) for a in (k, v, w))
            S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
        for t in reversed(range(t0, t1)):
            Sp = prev[t - t0]
            rt, kt, vt, wt, dyt = (a[:, t].to(dt) for a in (r, k, v, w, dy))
            e = (dyt * vt).sum(-1, keepdim=True)             # (B, H, 1)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", Sp, dyt) + uu * kt * e
            du += rt * kt * e
            dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uu * e
            c_t = (rt * uu * kt).sum(-1, keepdim=True)
            dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + c_t * dyt
            dw[:, t] = (G * Sp).sum(-1)
            G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, G)


class WKVScan(torch.autograd.Function):
    """WKV-6 on checked `(B, T, H, dh)` operands with its gradient: the
    forward keeps the state every CK tokens, the backward runs the
    reverse recurrence from them (the plain version on the CPU, the
    backward kernel on a CUDA device)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        B, T, H, dh = r.shape
        ckpt = torch.empty((B, H, n_checkpoints(T), dh, dh),
                           dtype=torch.promote_types(r.dtype, w.dtype),
                           device=r.device)
        if r.device.type == "cuda":
            from repro_torch.kernels import cuda_rwkv6_scan
            y, s = cuda_rwkv6_scan.launch(r, k, v, w, u, s0, ckpt=ckpt)
        elif r.device.type == "meta":
            from repro_torch.kernels import meta
            y, s = meta.rwkv6_scan(r, k, v, w, u, s0)
        else:
            y, s = rwkv6_scan_plain(r, k, v, w, u, s0, ckpt=ckpt)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.has_s0 = s0 is not None
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, ds):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=ckpt.dtype, device=r.device)
        if r.device.type == "cuda":
            from repro_torch.kernels import cuda_rwkv6_scan
            out = cuda_rwkv6_scan.launch_bwd(r, k, v, w, u, ckpt, dy, ds)
        elif r.device.type == "meta":
            from repro_torch.kernels import meta
            out = meta.rwkv6_scan_bwd(r, k, v, w, u, ckpt, dy, ds,
                                      ctx.has_s0)
        else:
            out = rwkv6_scan_bwd_plain(r, k, v, w, u, ckpt, dy, ds)
        dr, dk, dv, dw, du_rows, ds0 = out
        du = du_rows.sum(0) if u.dim() == 2 else du_rows
        return dr, dk, dv, dw, du, ds0 if ctx.has_s0 else None


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
    # float64 throughout: the plain version's reference precision, CPU only
    wdt = torch.float64 if xdt == torch.float64 and dev.type == "cpu" \
        else torch.float32
    for name, t in named:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
        if name in ("r", "k", "v"):
            if t.dtype != xdt or xdt not in X_DTYPES + (wdt,):
                raise TypeError(f"{name} must be torch.float32 or "
                                f"torch.bfloat16 like r, got {t.dtype}")
        elif t.dtype != wdt:
            raise TypeError(f"{name} must be {wdt}, got {t.dtype}")
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        if s_out is not None:
            raise ValueError("s_out (a state written in place) cannot be "
                             "used where autograd records a gradient")
        if r.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"no executor for device {r.device}")
        return WKVScan.apply(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0, s_out)
    if r.device.type == "cuda":
        from repro_torch.kernels import cuda_rwkv6_scan
        return cuda_rwkv6_scan.launch(r, k, v, w, u, s0, s_out)
    if r.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.rwkv6_scan(r, k, v, w, u, s0, s_out)
    raise ValueError(f"no executor for device {r.device}")
