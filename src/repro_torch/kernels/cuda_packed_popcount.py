"""ctypes wrapper of the hand-written popcount kernel
(`csrc/packed_popcount.cu`), which replaces the Pallas kernel
`repro/kernels/packed_popcount.py::_kernel`.

`plan` picks the design from the row width and the plane's address (pure
Python; the CPU tests reach it): `rows` (a thread a row, the block's run
of rows staged transposed in shared memory) for W <= `ROWS_MAX_W`, `warp`
(a warp a row) past it, and 16-byte loads only for a plane that starts on
a 16-byte boundary.  `launch` takes a CUDA tensor that
`packed_popcount.check_operands` accepted, allocates the `(B,)` int32
result, launches on the current stream and raises on a refused launch.
What bounds the kernel and what its design does about it is set out at
the top of the CUDA source.  Each launch adds one to
`LAUNCHES["packed_popcount"]` and one to `DESIGN_LAUNCHES` under its
design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "packed_popcount.cu"
LAUNCHES = {"packed_popcount": 0}
DESIGNS = ("rows", "warp")
DESIGN_LAUNCHES = {d: 0 for d in DESIGNS}
ROWS_MAX_W = 64          # widest row a `rows` block stages (33 KB of shared)
MAX_ROWS = 2 ** 31 - 1   # one grid dimension of blocks covers every row


class Plan(NamedTuple):
    design: str
    vec16: bool          # 16-byte loads: the plane is 16-byte aligned


def reset_launches() -> None:
    for d in (LAUNCHES, DESIGN_LAUNCHES):
        for k in d:
            d[k] = 0


def plan(B: int, W: int, data_ptr: int) -> Plan:
    """The design for a contiguous `(B, W)` plane at address `data_ptr`;
    the CUDA entry point sizes the grid and shared memory from B and W."""
    return Plan("rows" if W <= ROWS_MAX_W else "warp", data_ptr % 16 == 0)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `packed_popcount`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.packed_popcount.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, ci,
                                    vp]
    lib.packed_popcount.restype = ci
    return lib


def launch(words: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts of `(B, W)` int32 words on the card: `(B,)`."""
    B, W = words.shape
    out = torch.empty((B,), dtype=torch.int32, device=words.device)
    if B == 0:
        return out
    if B > MAX_ROWS:
        raise ValueError(f"B={B} exceeds the kernel's row limit {MAX_ROWS}")
    p = plan(B, W, words.data_ptr())
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = _lib().packed_popcount(words.data_ptr(), out.data_ptr(), B, W,
                                     DESIGNS.index(p.design), int(p.vec16),
                                     stream)
    if err:
        raise RuntimeError(f"packed_popcount launch failed: CUDA error {err}")
    LAUNCHES["packed_popcount"] += 1
    DESIGN_LAUNCHES[p.design] += 1
    return out
