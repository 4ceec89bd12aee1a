"""ctypes wrapper of the hand-written WKV-6 kernel (`csrc/rwkv6_scan.cu`),
which replaces the Pallas kernel `repro/kernels/rwkv6_scan.py::_kernel`.

`plan` is the wrapper's layout arithmetic, pure Python on the operands'
shapes, strides and addresses (the CPU tests reach it): the element steps
the kernel walks, and whether every operand row and token lies on a
16-byte boundary (the states too), which picks `cp.async` staging and
16-byte state loads over element-by-element ones.  `launch` takes
`(B, T, H, dh)` CUDA tensors that `rwkv6_scan.check_operands` accepted,
allocates y `(B, T, H, dh)` and, unless `s_out` is given, the final state
`(B, H, dh, dh)`, launches on the current stream and raises on a refused
launch or a head size the kernel is not built for; with `ckpt` (a
gradient run) the kernel instance that also keeps the state every
`rwkv6_scan.CK` tokens writes them there.  `launch_bwd` runs the
backward kernel (`rwkv6_scan_bwd_kernel`, same source) from those
checkpoints; `plan_bwd` is its layout arithmetic.  What bounds each kernel
and what its design does about it is set out in the CUDA source.  Each
forward launch adds one to `LAUNCHES["rwkv6_scan"]`, and one to
`DESIGN_LAUNCHES` under its staging; each backward launch one to
`LAUNCHES["rwkv6_scan_bwd"]`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "rwkv6_scan.cu"
LAUNCHES = {"rwkv6_scan": 0, "rwkv6_scan_bwd": 0}
DESIGNS = ("cp_async", "element")      # how a chunk is staged
DESIGN_LAUNCHES = {d: 0 for d in DESIGNS}
HEAD_SIZES = (16, 64)          # the kernel's DH instances: reduced, full
_Steps = ctypes.c_longlong * 11
_BwdSteps = ctypes.c_longlong * 9


class Plan(NamedTuple):
    """One launch: `steps` are the 11 element steps the C entry point
    takes (sB and sT of r, k, v and w, then u_sb and y's batch and token
    steps); `design` the chunk staging."""
    B: int
    T: int
    H: int
    dh: int
    steps: tuple[int, ...]
    bf16: bool
    design: str
    blocks: int


def reset_launches() -> None:
    for d in (LAUNCHES, DESIGN_LAUNCHES):
        for k in d:
            d[k] = 0


def plan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None,
         s_out: torch.Tensor | None = None) -> Plan:
    """The launch for checked `(B, T, H, dh)` operands.  A step of a
    dimension of size 1 is never taken, so it does not count against
    16-byte alignment; the states are read and written in 16-byte pieces
    too."""
    B, T, H, dh = r.shape
    steps = []
    # every address and byte step the kernel takes 16 bytes at a time,
    # or'ed together: 16-byte aligned iff its low four bits are clear
    bits = (0 if s0 is None else s0.data_ptr()) | (
        0 if s_out is None else s_out.data_ptr())
    for a in (r, k, v, w):
        sB, sT = a.stride()[:2]
        steps += (sB, sT)
        es = a.element_size()
        bits |= a.data_ptr() | dh * es | (sB * es if B > 1 else 0) | (
            sT * es if T > 1 else 0)
    steps += (H * dh if u.dim() == 3 else 0, T * H * dh, H * dh)
    return Plan(B, T, H, dh, tuple(steps), r.dtype == torch.bfloat16,
                DESIGNS[1] if bits % 16 else DESIGNS[0], B * H)


class BwdPlan(NamedTuple):
    """One backward launch: `steps` the 9 element steps the C entry point
    takes (sB and sT of r, k, v and w, then u_sb), `blocks` one a row
    (b, h), `smem_bytes` the kernel's dynamic shared memory, `hist_floats`
    the scratch a row (CK states)."""
    B: int
    T: int
    H: int
    dh: int
    steps: tuple[int, ...]
    bf16: bool
    blocks: int
    smem_bytes: int
    hist_floats: int


def plan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor) -> BwdPlan:
    """The backward launch for checked `(B, T, H, dh)` operands.  It reads
    r, k, v and w element by element, so no alignment is asked; the
    shared memory is `BwdSmem<dh>` of the source: the chunk's five
    operand planes, the row groups' dv partial sums, u and two scalars a
    token."""
    from repro_torch.kernels.rwkv6_scan import CK

    B, T, H, dh = r.shape
    steps = []
    for a in (r, k, v, w):
        steps += a.stride()[:2]
    steps.append(H * dh if u.dim() == 3 else 0)
    groups = dh // (8 if dh == 64 else 4)      # row groups: DH / R
    smem = 4 * (5 * CK * dh + CK * groups * dh + dh + 2 * CK)
    return BwdPlan(B, T, H, dh, tuple(steps), r.dtype == torch.bfloat16,
                   B * H, smem, CK * dh * dh)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with both entry points' C signatures declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.rwkv6_scan.restype = ci
    lib.rwkv6_scan_bwd.argtypes = [vp] * 16 + [ci] * 5 + [vp]
    lib.rwkv6_scan_bwd.restype = ci
    return lib


def _call(fn, dev: torch.device, *args) -> int:
    """`fn(*args, stream)` on `dev`'s current stream, with `dev` current."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
           s_out: torch.Tensor | None = None,
           ckpt: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence on the card: `(y, final state)`, float32.
    `ckpt`, a contiguous `(B, H, ceil(T / CK), dh, dh)` float32 tensor,
    receives the state every CK tokens."""
    if s_out is None:
        s_out = torch.empty((r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                            dtype=torch.float32, device=r.device)
    p = plan(r, k, v, w, u, s0, s_out)
    if p.dh not in HEAD_SIZES:
        raise ValueError(f"head size {p.dh} is not one the kernel is built "
                         f"for {HEAD_SIZES}")
    y = torch.empty((p.B, p.T, p.H, p.dh), dtype=torch.float32,
                    device=r.device)
    if p.blocks == 0:
        return y, s_out
    steps = _Steps(*p.steps)
    if ckpt is not None and not (ckpt.is_contiguous()
                                 and ckpt.device == r.device
                                 and ckpt.dtype == torch.float32):
        raise ValueError("ckpt must be a contiguous float32 tensor on r's "
                         "device")
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(),
            ctypes.addressof(steps), p.blocks, p.H, p.T, p.dh, int(p.bf16),
            int(p.design == "cp_async"))
    err = _call(_lib().rwkv6_scan, r.device, *args)
    if err:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    LAUNCHES["rwkv6_scan"] += 1
    DESIGN_LAUNCHES[p.design] += 1
    return y, s_out


def launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
               dy: torch.Tensor, ds: torch.Tensor | None) -> tuple:
    """The backward kernel on the card, from the forward's checkpoints:
    `(dr, dk, dv, dw, du_rows, ds0)` as `rwkv6_scan_bwd_plain` returns
    them (dr, dk, dv in r's dtype, the rest float32)."""
    p = plan_bwd(r, k, v, w, u)
    if p.dh not in HEAD_SIZES:
        raise ValueError(f"head size {p.dh} is not one the kernel is built "
                         f"for {HEAD_SIZES}")
    dev = r.device
    dy = dy.to(torch.float32).contiguous()
    ds = None if ds is None else ds.to(torch.float32).contiguous()
    shape = (p.B, p.T, p.H, p.dh)
    dr, dk, dv = (torch.empty(shape, dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    du = torch.empty((p.B, p.H, p.dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((p.B, p.H, p.dh, p.dh), dtype=torch.float32,
                      device=dev)
    if p.blocks == 0:
        return dr, dk, dv, dw, du, ds0
    hist = torch.empty((p.blocks, p.hist_floats), dtype=torch.float32,
                       device=dev)
    steps = _BwdSteps(*p.steps)
    err = _call(_lib().rwkv6_scan_bwd, dev, r.data_ptr(), k.data_ptr(),
                v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
                dy.data_ptr(), None if ds is None else ds.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                du.data_ptr(), ds0.data_ptr(), hist.data_ptr(),
                ctypes.addressof(steps), p.blocks, p.H, p.T, p.dh,
                int(p.bf16))
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["rwkv6_scan_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
