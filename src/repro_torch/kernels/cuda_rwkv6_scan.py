"""ctypes wrapper of the hand-written WKV-6 kernel (`csrc/rwkv6_scan.cu`),
which replaces the Pallas kernel `repro/kernels/rwkv6_scan.py::_kernel`.

`launch` takes CUDA tensors that `rwkv6_scan.check_operands` accepted,
allocates y `(BH, T, dh)` and the final state `(BH, dh, dh)`, launches on
the current stream and raises on a refused launch or a head size the
kernel is not built for.  What bounds the kernel and what its design does
about it is set out at the top of the CUDA source.  Each launch adds one
to `LAUNCHES["rwkv6_scan"]`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "rwkv6_scan.cu"
LAUNCHES = {"rwkv6_scan": 0}
HEAD_SIZES = (16, 64)          # the kernel's DH instances: reduced, full


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `rwkv6_scan`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan.argtypes = [vp] * 8 + [ci, ci, ci, vp]
    lib.rwkv6_scan.restype = ci
    return lib


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence on the card: `(y, final state)`, float32."""
    BH, T, dh = r.shape
    if dh not in HEAD_SIZES:
        raise ValueError(f"head size {dh} is not one the kernel is built "
                         f"for {HEAD_SIZES}")
    y = torch.empty_like(r)
    s_out = torch.empty((BH, dh, dh), dtype=torch.float32, device=r.device)
    if BH == 0:
        return y, s_out
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), BH, T, dh, stream)
    if err:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    LAUNCHES["rwkv6_scan"] += 1
    return y, s_out
