"""ctypes wrapper of the hand-written ternary-matmul kernel
(`csrc/ternary_matmul.cu`), which replaces the Pallas kernel
`repro/kernels/ternary_matmul.py::_kernel`.

`launch` takes CUDA tensors that `ternary_matmul.check_operands` accepted,
allocates the `(M, N)` f32 output, launches on the current stream and
raises on a refused launch.  What bounds the kernel and what its design
does about it is set out at the top of the CUDA source.  Each launch adds
one to `LAUNCHES["ternary_matmul"]`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "ternary_matmul.cu"
LAUNCHES = {"ternary_matmul": 0}
MAX_BLOCK_M = 8        # rows of x per block
MAX_GRID_Y = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `ternary_matmul`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ternary_matmul.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.ternary_matmul.restype = ci
    return lib


def launch(x: torch.Tensor, w2: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """`(x @ unpack(w2)) * scale` on the card: `(M, N)` f32."""
    M, K = x.shape
    N = w2.shape[1]
    dev = x.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    if -(-M // MAX_BLOCK_M) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid limit "
                         f"{MAX_GRID_Y * MAX_BLOCK_M}")
    # 4-byte weight loads need every packed row to start 4-byte aligned
    vec = int(N % 4 == 0 and w2.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ternary_matmul(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w2.data_ptr(),
            scale.data_ptr(), out.data_ptr(), M, K, N, vec, stream)
    if err:
        raise RuntimeError(f"ternary_matmul launch failed: CUDA error {err}")
    LAUNCHES["ternary_matmul"] += 1
    return out
