"""ctypes wrapper of the hand-written grouped ternary expert GEMM
(`csrc/expert_matmul.cu`), which replaces no Pallas kernel: the
reference's MoE multiplies dense experts over capacity slots with
einsums; this serves the port's dropless MoE (`models/moe.py`).

`plan(M, K, N, E, x_dtype, x_align)` routes one call (a pure function, so
the routing is tested on the CPU): `tensor_core` — bf16 x, 16-byte
aligned, K a multiple of 8 — is the only design; anything else raises, as
a refused launch would.  Its grid is `(ceil(N / 128), ceil(M / 128) + E)`:
the second number bounds the (expert, 128-row tile) pairs whatever the
counts, so the counts never come to the host; the blocks past the last
pair exit.  `launch` takes CUDA tensors `expert_matmul.check_operands`
accepted, allocates the `(M, N)` f32 output, launches on the current
stream and raises on a refused launch.  Each launch adds one to
`LAUNCHES["expert_matmul"]` and one to its `(M, K, N, E)` in
`SHAPE_LAUNCHES`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "expert_matmul.cu"
KERNEL = "expert_mma_kernel"
LAUNCHES = {"expert_matmul": 0}
SHAPE_LAUNCHES: collections.Counter = collections.Counter()
BLOCK_M = 128                # rows of x a block (one expert's)
BLOCK_N = 128                # output columns a block
MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """One call: the design and the grid `(column tiles, row tiles
    bound)`."""
    variant: str
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, E: int, x_dtype: torch.dtype,
         x_align: int = 16) -> Plan:
    """The grid of `(M, K)` rows grouped over E experts times `(E, K//4,
    N)` packed codes.  Raises on what the kernel cannot take: x not
    bf16 (`TypeError`), x off a 16-byte boundary, K not a multiple of 8,
    M, N or E below 1 (M may be 0), or a grid past its limit
    (`ValueError`)."""
    if x_dtype != torch.bfloat16:
        raise TypeError(f"the grouped expert kernel takes bf16 x, got "
                        f"{x_dtype}")
    if K < 8 or K % 8:
        raise ValueError(f"K={K} must be a positive multiple of 8")
    if x_align < 16:
        raise ValueError("x must lie on a 16-byte boundary")
    if M < 0 or N < 1 or E < 1:
        raise ValueError(f"M={M}, N={N} and E={E} must be at least 0, 1, 1")
    grid = (_cdiv(N, BLOCK_N), _cdiv(M, BLOCK_M) + E)
    if grid[1] > MAX_GRID_YZ:
        raise ValueError(f"(M={M}, E={E}) needs {grid[1]} row tiles, past "
                         f"the limit {MAX_GRID_YZ}")
    return Plan("tensor_core", grid)


def reset_launches() -> None:
    LAUNCHES["expert_matmul"] = 0
    SHAPE_LAUNCHES.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `expert_matmul`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp = ctypes.c_void_p
    lib.expert_matmul.argtypes = [vp, vp, vp, vp, vp,
                                  ctypes.POINTER(ctypes.c_int), vp]
    lib.expert_matmul.restype = ctypes.c_int
    return lib


def _align(ptr: int) -> int:
    return min(16, ptr & -ptr) if ptr else 16


@functools.lru_cache(maxsize=4096)
def _launch_args(M: int, K: int, N: int, E: int, x_align: int,
                 w_align: int) -> tuple[Plan, ctypes.Array]:
    """The plan and the C call's seven shape arguments, once per shape."""
    p = plan(M, K, N, E, torch.bfloat16, x_align)
    vec_w = int(N % 16 == 0 and w_align >= 16)
    return p, (ctypes.c_int * 7)(M, K, N, E, p.grid[1], vec_w,
                                 int(N % 2 == 0))


def launch(x: torch.Tensor, w2: torch.Tensor, scale: torch.Tensor,
           offsets: torch.Tensor) -> torch.Tensor:
    """Each expert's rows of x times its codes, scaled: `(M, N)` f32."""
    M, K = x.shape
    E, _, N = w2.shape
    if x.dtype != torch.bfloat16:
        plan(M, K, N, E, x.dtype)          # raises
    p, args = _launch_args(M, K, N, E, _align(x.data_ptr()),
                           _align(w2.data_ptr()))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().expert_matmul(
            x.data_ptr(), w2.data_ptr(), scale.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), args, stream)
    if err:
        raise RuntimeError(f"expert_matmul ({p.variant}) launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["expert_matmul"] += 1
    SHAPE_LAUNCHES[M, K, N, E] += 1
    return out
