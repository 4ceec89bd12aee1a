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
backward kernel (`rwkv6_scan_bwd_kernel`, same source: a cluster of
CTAs a row, no scratch in device memory) from those checkpoints;
`plan_bwd` is its layout arithmetic and geometry, `card_geometry` what
the card makes of it (CTAs an SM, registers).  What bounds each kernel
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
    takes (sB and sT of r, k, v and w, then u_sb); a row (b, h) is a
    cluster of `clusters` CTAs of `threads` threads each, `blocks` CTAs
    in all; `smem_bytes` a CTA's dynamic shared memory (`BwdSmem` of the
    source); `design` the chunk staging, as the forward's `plan` picks
    it.  The kernel takes no scratch in device memory."""
    B: int
    T: int
    H: int
    dh: int
    steps: tuple[int, ...]
    bf16: bool
    design: str
    clusters: int
    threads: int
    blocks: int
    smem_bytes: int


def bwd_geometry(dh: int) -> tuple[int, int]:
    """`BwdGeo<dh>` of the source: (CTAs a row, threads a CTA).  A CTA
    owns dh / P value columns of the row, four threads share a key-row
    pair, and a thread a 2 x (dh / 4P) tile."""
    clusters = 2 if dh == 64 else 1
    return clusters, 4 * (dh // 2)


def bwd_smem_bytes(dh: int, bf16: bool) -> int:
    """`sizeof(BwdSmem<dh, T>)`: the chunk as staged (r, k all rows and v
    the CTA's columns in their type, w all rows and dy the CTA's columns
    float32), its float32 planes, the states kept before the even tokens
    of half a chunk (a tile a thread), the sums the cluster exchanges for
    two halves (a float4 a key row and e_t's share: 4 dh + 4 floats a
    token), each warp's dv, u, c_t and e_t."""
    from repro_torch.kernels.rwkv6_scan import CK

    P, NT = bwd_geometry(dh)
    half, jw = CK // 2, dh // P
    floats = (CK * dh + CK * jw                       # w, dy as staged
              + 3 * CK * dh + 2 * CK * jw             # planes
              + half // 2 * 2 * NT * (jw // 4)        # hist
              + 2 * half * (4 * dh + 4)               # xch
              + half * (NT // 32) * jw                # dvw
              + dh + 2 * CK)
    return (2 if bf16 else 4) * (2 * CK * dh + CK * jw) + 4 * floats


def plan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             *states: torch.Tensor | None) -> BwdPlan:
    """The backward launch for checked `(B, T, H, dh)` operands.  The
    chunk is staged 16 bytes at a time when every address and byte step
    it takes is a multiple of 16 -- r, k, v and w as in `plan`, and the
    tensors in `states` (dy, the checkpoints, ds: read whole, so only
    their addresses count) -- else element by element."""
    B, T, H, dh = r.shape
    steps = []
    bits = 0
    for a in (r, k, v, w):
        sB, sT = a.stride()[:2]
        steps += (sB, sT)
        es = a.element_size()
        bits |= a.data_ptr() | dh * es | (sB * es if B > 1 else 0) | (
            sT * es if T > 1 else 0)
    for a in states:
        bits |= 0 if a is None else a.data_ptr()
    steps.append(H * dh if u.dim() == 3 else 0)
    bf16 = r.dtype == torch.bfloat16
    P, NT = bwd_geometry(dh)
    return BwdPlan(B, T, H, dh, tuple(steps), bf16,
                   DESIGNS[1] if bits % 16 else DESIGNS[0], P, NT,
                   B * H * P, bwd_smem_bytes(dh, bf16))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with both entry points' C signatures declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.rwkv6_scan.restype = ci
    lib.rwkv6_scan_bwd.argtypes = [vp] * 15 + [ci] * 6 + [vp]
    lib.rwkv6_scan_bwd.restype = ci
    lib.rwkv6_scan_bwd_geometry.argtypes = [ci] * 3 + [vp]
    lib.rwkv6_scan_bwd_geometry.restype = ci
    return lib


def card_geometry(dh: int, bf16: bool, design: str = "cp_async") -> dict:
    """The backward kernel instance on the current card, as the CUDA
    runtime reports it: CTAs a row, threads a CTA, dynamic shared memory,
    CTAs an SM holds, clusters the card holds at once, registers and
    local memory (spills) a thread."""
    out = (ctypes.c_int * 7)()
    err = _lib().rwkv6_scan_bwd_geometry(dh, int(bf16),
                                         int(design == "cp_async"),
                                         ctypes.addressof(out))
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd_geometry failed: CUDA error "
                           f"{err}")
    keys = ("clusters", "threads", "smem_bytes", "ctas_per_sm",
            "max_active_clusters", "registers", "local_bytes")
    return dict(zip(keys, out))


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
    if r.shape[3] not in HEAD_SIZES:
        raise ValueError(f"head size {r.shape[3]} is not one the kernel is "
                         f"built for {HEAD_SIZES}")
    dev = r.device
    dy = dy.to(torch.float32).contiguous()
    ds = None if ds is None else ds.to(torch.float32).contiguous()
    p = plan_bwd(r, k, v, w, u, dy, ckpt, ds)
    shape = (p.B, p.T, p.H, p.dh)
    dr, dk, dv = (torch.empty(shape, dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    du = torch.empty((p.B, p.H, p.dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((p.B, p.H, p.dh, p.dh), dtype=torch.float32,
                      device=dev)
    if p.blocks == 0:
        return dr, dk, dv, dw, du, ds0
    steps = _BwdSteps(*p.steps)
    err = _call(_lib().rwkv6_scan_bwd, dev, r.data_ptr(), k.data_ptr(),
                v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
                dy.data_ptr(), None if ds is None else ds.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                du.data_ptr(), ds0.data_ptr(), ctypes.addressof(steps),
                p.B * p.H, p.H, p.T, p.dh, int(p.bf16),
                int(p.design == "cp_async"))
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["rwkv6_scan_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
