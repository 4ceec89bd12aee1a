"""ctypes wrapper of the hand-written popcount kernel
(`csrc/packed_popcount.cu`), which replaces the Pallas kernel
`repro/kernels/packed_popcount.py::_kernel`.

`launch` takes a CUDA tensor that `packed_popcount.check_operands`
accepted, allocates the `(B,)` int32 result, launches on the current
stream and raises on a refused launch.  What bounds the kernel and what
its design does about it is set out at the top of the CUDA source.  Each
launch adds one to `LAUNCHES["packed_popcount"]`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "packed_popcount.cu"
LAUNCHES = {"packed_popcount": 0}
MAX_ROWS = 2 ** 26     # up to 32 lanes a row, int32 thread indices


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `packed_popcount`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.packed_popcount.argtypes = [vp, vp, ci, ci, vp]
    lib.packed_popcount.restype = ci
    return lib


def launch(words: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts of `(B, W)` int32 words on the card: `(B,)`."""
    B, W = words.shape
    out = torch.empty((B,), dtype=torch.int32, device=words.device)
    if B == 0:
        return out
    if B >= MAX_ROWS:
        raise ValueError(f"B={B} exceeds the kernel's row limit {MAX_ROWS}")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = _lib().packed_popcount(words.data_ptr(), out.data_ptr(), B, W,
                                     stream)
    if err:
        raise RuntimeError(f"packed_popcount launch failed: CUDA error {err}")
    LAUNCHES["packed_popcount"] += 1
    return out
