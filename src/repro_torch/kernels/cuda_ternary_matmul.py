"""ctypes wrapper of the hand-written ternary-matmul kernels
(`csrc/ternary_matmul.cu`), which replace the Pallas kernel
`repro/kernels/ternary_matmul.py::_kernel`.

`plan(M, K, N, x_dtype)` routes a shape to one of three designs, by M and
x's dtype (a pure function, so the routing is tested on the CPU):

* `split_k` — M <= 8, either dtype: a packed GEMV on the CUDA cores with
  K split across blocks so decode fills the card, the splits reduced in a
  fixed order in the same launch;
* `tensor_core` — M > 8 with bf16 x: `wgmma` with the codes decoded to
  bf16 in registers as its A operand and x's tile from shared memory, the
  tile rows (128, 96 or 64) and K splits chosen per shape;
* `cuda_core` — M > 8 with f32 x (the float32 model and the tests), or
  bf16 x whose address is not 8-byte aligned.

`launch` takes CUDA tensors that `ternary_matmul.check_operands` accepted,
allocates the `(M, N)` f32 output, launches on the current stream and
raises on a refused launch.  The split designs' workspace and zeroed
counters are allocated once per device and grown when a larger plan needs
more, so a decode step adds no torch op and no launch; the kernel leaves
the counters at 0, and they assume one stream.  What bounds each design
and what it does about it is set out at the top of the CUDA source.  Each
launch adds one to `LAUNCHES["ternary_matmul"]`, one to its variant's
count in `VARIANT_LAUNCHES` and one to its `(M, K, N, x dtype)` in
`SHAPE_LAUNCHES`, so a caller can hold the kernel against its plain
version at exactly the shapes a served run gave it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "ternary_matmul.cu"
LAUNCHES = {"ternary_matmul": 0}
VARIANTS = ("split_k", "tensor_core", "cuda_core")
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
SHAPE_LAUNCHES: collections.Counter = collections.Counter()

SMS = 132                    # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS      # split-K blocks resident at once (2 a SM)
SPLIT_K_MAX_M = 8            # rows of x the split-K GEMV takes
GEMV_BLOCK_N = 64            # output columns per split-K block
GEMV_MIN_ROWS = 16           # packed rows per split, least...
GEMV_MAX_ROWS = 256          # ...and most (the x slice in shared memory)
MMA_BLOCK_N = 128            # output columns per tensor-core block
MMA_STEP_ROWS = 16           # packed rows per K step (64 values of k)
MMA_MIN_STEPS = 4            # K steps per split, least
MMA_BLOCK_M = (128, 96, 64)  # rows of x per tensor-core block, by preference
MMA_FULL_TILES = 120         # output tiles that fill the card unsplit
MMA_SPLITS = 4               # K splits below that
CORE_BLOCK = (8, 128)        # rows x columns per CUDA-core block
MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """How one `(M, K, N)` call runs: the design, the K splits (each
    `rows` packed rows of `K // 4`, the last one ragged), the block tile
    `(rows of x, output columns)` and the grid `(x, y, z)`."""
    variant: str
    splits: int
    rows: int
    tile: tuple[int, int]
    grid: tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def tiles(self) -> int:
        """Output tiles, one reduction counter each."""
        return self.grid[0] * self.grid[1]

    @property
    def workspace_floats(self) -> int:
        """f32 partial sums the split reduction needs (0 without one)."""
        if self.splits == 1:
            return 0
        return self.splits * self.tiles * self.tile[0] * self.tile[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(K4: int, want: int, min_rows: int, max_rows: int | None,
           align: int) -> tuple[int, int]:
    """`(splits, rows)`: about `want` splits of K4 packed rows, each a
    multiple of `align` rows and between `min_rows` and `max_rows`, the
    splits covering K4 exactly with none empty."""
    if K4 == 0:
        return 1, 0
    if max_rows is not None:
        want = max(want, _cdiv(K4, max_rows))
    rows = max(min_rows, _cdiv(_cdiv(K4, want), align) * align)
    return _cdiv(K4, rows), rows


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, x_dtype: torch.dtype,
         x_align: int = 16) -> Plan:
    """The design, K splits and tile for `(M, K) @ (K//4, N)` packed.

    `x_align` is the largest power of two (up to 16) dividing x's address.
    Raises as `check_operands` does on what the kernels cannot take: a
    dtype other than float32 or bfloat16 (`TypeError`), K not a multiple
    of 4, M or N below 1, or a grid past its limit (`ValueError`)."""
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x_dtype}")
    if K < 0 or K % 4:
        raise ValueError(f"K={K} must be a non-negative multiple of 4")
    if M < 1 or N < 1:
        raise ValueError(f"M={M} and N={N} must be at least 1")
    K4 = K // 4
    if M <= SPLIT_K_MAX_M:
        # as many splits as keep the grid inside one wave of resident
        # blocks (two a SM at the 8-row tile's registers)
        tiles = _cdiv(N, GEMV_BLOCK_N)
        splits, rows = _split(K4, max(1, TARGET_BLOCKS // tiles),
                              GEMV_MIN_ROWS, GEMV_MAX_ROWS, 1)
        p = Plan("split_k", splits, rows, (SPLIT_K_MAX_M, GEMV_BLOCK_N),
                 (tiles, 1, splits))
    elif x_dtype == torch.bfloat16 and x_align >= 8:
        # the most rows of x a block (of MMA_BLOCK_M) that still give
        # MMA_FULL_TILES output tiles; else the fewest, with K split
        nt = _cdiv(N, MMA_BLOCK_N)
        bm = next((b for b in MMA_BLOCK_M
                   if _cdiv(M, b) * nt >= MMA_FULL_TILES), MMA_BLOCK_M[-1])
        tiles = _cdiv(M, bm) * nt
        want = 1 if tiles >= MMA_FULL_TILES else MMA_SPLITS
        splits, rows = _split(K4, want, MMA_MIN_STEPS * MMA_STEP_ROWS, None,
                              MMA_STEP_ROWS)
        p = Plan("tensor_core", splits, rows, (bm, MMA_BLOCK_N),
                 (_cdiv(N, MMA_BLOCK_N), _cdiv(M, bm), splits))
    else:
        p = Plan("cuda_core", 1, K4, CORE_BLOCK,
                 (_cdiv(N, CORE_BLOCK[1]), _cdiv(M, CORE_BLOCK[0]), 1))
    if max(p.grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"(M={M}, K={K}, N={N}) needs grid {p.grid}, past "
                         f"the limit {MAX_GRID_YZ} in y and z")
    return p


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0
    SHAPE_LAUNCHES.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `ternary_matmul`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ternary_matmul.argtypes = [vp, ci, vp, vp, vp, vp, vp,
                                   ctypes.POINTER(ci), vp]
    lib.ternary_matmul.restype = ci
    return lib


_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, p: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """This device's workspace and zeroed counters, grown to fit `p`."""
    ws, cnt = _SCRATCH.get(dev, (None, None))
    if ws is not None and ws.numel() >= p.workspace_floats \
            and cnt.numel() >= p.tiles:
        return ws, cnt
    if ws is None or ws.numel() < p.workspace_floats:
        ws = torch.empty(max(p.workspace_floats, 1), dtype=torch.float32,
                         device=dev)
    if cnt is None or cnt.numel() < p.tiles:
        cnt = torch.zeros(p.tiles, dtype=torch.int32, device=dev)
    _SCRATCH[dev] = (ws, cnt)
    return ws, cnt


def _align(ptr: int) -> int:
    return min(16, ptr & -ptr) if ptr else 16


@functools.lru_cache(maxsize=4096)
def _launch_args(M: int, K: int, N: int, x_dtype: torch.dtype, x_align: int,
                 w_align: int) -> tuple[Plan, ctypes.Array]:
    """The plan and the C call's ten shape arguments (as one int array),
    computed once per shape and alignment, so a decode step pays a cache
    lookup and a short ctypes call a launch."""
    p = plan(M, K, N, x_dtype, x_align)
    if p.variant == "cuda_core":          # 4-byte loads of packed rows
        vec_w = int(N % 4 == 0 and w_align >= 4)
    else:                                 # 16-byte loads of packed rows
        vec_w = int(N % 16 == 0 and w_align >= 16)
    # 16-byte copies of x: whole groups of 8 (tensor cores) or 4 values
    vec_x = int(x_align >= 16 and (K % 8 == 0 or p.variant == "split_k"))
    vec_out = int(N % 2 == 0)             # paired stores of out
    return p, (ctypes.c_int * 10)(M, K, N, VARIANTS.index(p.variant),
                                  p.splits, p.rows, p.tile[0], vec_x, vec_w,
                                  vec_out)


def launch(x: torch.Tensor, w2: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """`(x @ unpack(w2)) * scale` on the card: `(M, N)` f32."""
    M, K = x.shape
    N = w2.shape[1]
    dev = x.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    p, args = _launch_args(M, K, N, x.dtype, _align(x.data_ptr()),
                           _align(w2.data_ptr()))
    ws, cnt = _scratch(dev, p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ternary_matmul(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w2.data_ptr(),
            scale.data_ptr(), out.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
            args, stream)
    if err:
        raise RuntimeError(f"ternary_matmul ({p.variant}) launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["ternary_matmul"] += 1
    VARIANT_LAUNCHES[p.variant] += 1
    SHAPE_LAUNCHES[M, K, N, x.dtype] += 1
    return out
