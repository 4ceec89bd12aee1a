"""ctypes wrapper of the hand-written fused attention forward
(`csrc/attention.cu`), which replaces no Pallas kernel: the reference leaves
attention to XLA einsums, and the port's plain version
(`models/attention.py` `blockwise_attention_plain`) runs it as f32 einsums
over scores it materialises in device memory.

`plan` routes one call (a pure function of shapes, dtypes, the device
type and whether autograd records, so the routing is tested on the CPU):

* `fused` — CUDA tensors, q, k and v bf16, a head size the kernel is
  built for (64 or 128), autograd not recording for them, every query row
  seeing at least one key, H a multiple of K with at most 128 query heads a
  KV head, the grid inside its limits;
* `blockwise` — anything else: the plain version, unchanged (training of
  attention archs, the CPU, f32, and rows that see no key, where the plain
  version averages every key).

`key_tiles`, `tile_ranges` and `tiles_computed` are the kernel's tile
arithmetic in Python: which 64-key tiles each warpgroup of 64 query rows
multiplies.  `launch` takes CUDA tensors `plan` routed to `fused`,
allocates the bf16 `(B, Sq, H, dh)` output, launches on the current stream
and raises on a refused launch.  Every routed call adds one to
`LAUNCHES["attention"]` and one to its route's count in
`VARIANT_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

SOURCE = "attention.cu"
ROUTES = ("fused", "blockwise")
LAUNCHES = {"attention": 0}
VARIANT_LAUNCHES = dict.fromkeys(ROUTES, 0)
HEAD_DIMS = (64, 128)        # the kernel's DH instances
BLOCK_N = 64                 # keys a tile
WG_ROWS = 64                 # query rows (position, head) a warpgroup
CTA_ROWS = 128               # two warpgroups a CTA
MAX_GRID_YZ = 65535
LOG2E = math.log2(math.e)


class Plan(NamedTuple):
    """One call: its route, why it is not fused (empty when it is), the
    query positions a CTA (128 // G) and the grid (query tiles, K, B)."""
    route: str
    why: str
    positions: int
    grid: tuple[int, int, int]


def rows_see_a_key(sq: int, sk: int, causal: bool, window: int | None,
                   q_offset: int) -> bool:
    """Whether every query row sees at least one key.  Row i (absolute
    position q_offset + i) sees keys j < sk with j <= q_offset + i if
    causal and q_offset + i - j < window if a window is given."""
    if sk < 1 or (window is not None and window < 1):
        return False
    if causal and q_offset < 0:           # the first row's keys end before 0
        return False
    # the last row's window starts latest
    return window is None or max(0, q_offset + sq - window) <= sk - 1


def key_tiles(q_lo: int, q_hi: int, sk: int, causal: bool,
              window: int | None, tile: int = BLOCK_N) -> tuple[int, int]:
    """Key tiles `[lo, hi)` of `tile` keys holding a key visible to some
    row whose absolute position lies in `[q_lo, q_hi]` (the kernel's
    `key_tiles`)."""
    begin, end = 0, sk
    if causal:
        end = min(end, q_hi + 1)
    if window is not None:
        begin = max(0, q_lo - window + 1)
    if end <= begin:
        return 0, 0
    return begin // tile, -(-end // tile)


def tile_ranges(sq: int, sk: int, *, causal: bool, window: int | None,
                q_offset: int, g: int = 1, tile: int = BLOCK_N
                ) -> list[tuple[int, int]]:
    """The key tiles `[lo, hi)` each warpgroup multiplies, one entry per
    warpgroup with valid rows, for G = `g` query heads a KV head stacked
    into the rows (row r of a CTA is position p0 + r // g)."""
    positions = CTA_ROWS // g
    out = []
    for p0 in range(0, sq, positions):
        rows = min(positions, sq - p0) * g
        for first in range(0, rows, WG_ROWS):
            last = min(first + WG_ROWS, rows) - 1
            out.append(key_tiles(q_offset + p0 + first // g,
                                 q_offset + p0 + last // g, sk, causal,
                                 window, tile))
    return out


def tiles_computed(sq: int, sk: int, *, causal: bool, window: int | None,
                   q_offset: int, g: int = 1, tile: int = BLOCK_N) -> int:
    """Key tiles the kernel multiplies for one (batch row, KV head): the
    sum over warpgroups of `tile_ranges`."""
    return sum(hi - lo for lo, hi in tile_ranges(
        sq, sk, causal=causal, window=window, q_offset=q_offset, g=g,
        tile=tile))


@functools.lru_cache(maxsize=4096)
def plan(q_shape: tuple, k_shape: tuple, *, dtypes: tuple,
         device_type: str, recording: bool, causal: bool,
         window: int | None, q_offset: int) -> Plan:
    """The route of one `blockwise_attention` call (module docstring)."""
    b, sq, hh, dh = q_shape
    sk, kk = k_shape[1], k_shape[2]
    g = hh // kk if kk else 0
    positions = CTA_ROWS // g if g else 0
    grid = (-(-sq // positions) if positions else 0, kk, b)
    why = ""
    if device_type != "cuda":
        why = f"tensors on {device_type}"
    elif any(d != torch.bfloat16 for d in dtypes):
        why = "q, k and v are not all bf16"
    elif dh not in HEAD_DIMS:
        why = f"head size {dh} (the kernel has {HEAD_DIMS})"
    elif recording:
        why = "autograd records (the kernel has no backward)"
    elif b < 1 or sq < 1 or not kk or hh % kk or g > CTA_ROWS:
        why = f"shape q {q_shape}, k {k_shape}"
    elif not rows_see_a_key(sq, sk, causal, window, q_offset):
        why = "a query row sees no key"
    elif max(kk, b) > MAX_GRID_YZ:
        why = f"grid {grid} past {MAX_GRID_YZ} in y or z"
    return Plan("blockwise" if why else "fused", why, positions, grid)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: int | None, q_offset: int) -> Plan:
    """`plan` for these tensors."""
    recording = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return plan(tuple(q.shape), tuple(k.shape),
                dtypes=(q.dtype, k.dtype, v.dtype),
                device_type=q.device.type, recording=recording,
                causal=causal, window=window, q_offset=q_offset)


def count(route_name: str) -> None:
    LAUNCHES["attention"] += 1
    VARIANT_LAUNCHES[route_name] += 1


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `attention_fwd`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp = ctypes.c_void_p
    lib.attention_fwd.argtypes = [vp, vp, vp, vp,
                                  ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_float, vp]
    lib.attention_fwd.restype = ctypes.c_int
    return lib


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` if its rows of dh are contiguous and on 16-byte boundaries (the
    kernel's 16-byte copies), else a contiguous copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in t.stride()[:-1])
    return t if ok else t.contiguous()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: Plan, *,
           causal: bool, window: int | None, q_offset: int) -> torch.Tensor:
    """The fused kernel on CUDA tensors `p` routed to `fused`: bf16
    `(B, Sq, H, dh)`, contiguous."""
    b, sq, hh, dh = q.shape
    sk, kk = k.shape[1], k.shape[2]
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    out = torch.empty((b, sq, hh, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    args = (ctypes.c_int * 10)(b, sq, sk, hh, kk, dh, int(causal),
                               window or 0, q_offset, p.positions)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), strides, args,
                                   LOG2E * dh ** -0.5, stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err}")
    count("fused")
    return out
