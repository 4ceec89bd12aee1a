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
launch or a head size the kernel is not built for.  What bounds the kernel and what its design does about it
is set out at the top of the CUDA source.  Each launch adds one to
`LAUNCHES["rwkv6_scan"]`, and one to `DESIGN_LAUNCHES` under its staging.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "rwkv6_scan.cu"
LAUNCHES = {"rwkv6_scan": 0}
DESIGNS = ("cp_async", "element")      # how a chunk is staged
DESIGN_LAUNCHES = {d: 0 for d in DESIGNS}
HEAD_SIZES = (16, 64)          # the kernel's DH instances: reduced, full
_Steps = ctypes.c_longlong * 11


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


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `rwkv6_scan`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.rwkv6_scan.restype = ci
    return lib


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
           s_out: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence on the card: `(y, final state)`, float32."""
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
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), ctypes.addressof(steps),
            p.blocks, p.H, p.T, p.dh, int(p.bf16),
            int(p.design == "cp_async"))
    dev = r.device
    if dev.index == torch.cuda.current_device():
        err = _lib().rwkv6_scan(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _lib().rwkv6_scan(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    LAUNCHES["rwkv6_scan"] += 1
    DESIGN_LAUNCHES[p.design] += 1
    return y, s_out
