"""The training head and cross-entropy as one `torch.autograd.Function`
on hand-written Hopper kernels (`csrc/ce_head.cu`).

It replaces no Pallas kernel: the reference leaves the head and the loss to
XLA einsums (`repro.models.transformer.chunked_ce_loss`).  The port's
`models.transformer.chunked_ce_loss` routes each call by `plan` (a pure
function of shapes, dtypes, the device type and the head's layout, so the
routing is tested on the CPU):

* `fused` — CUDA tensors, bf16 hidden states and a bf16 dense head with no
  bias, the untied `(K, V)` head row-major (read in place), K a multiple
  of 64 and V of 8, the grid inside its limits: `CEHead`, whose forward
  runs `ce_lse` over every row of the call and whose backward runs, chunk
  of `Plan.chunk_rows` rows by chunk, `ce_grad` (D = dlogits as three bf16
  planes), `ce_dx` and `ce_dw` (dW in f32 across the chunks, cast once);
* `plain` — anything else, the tied `(V, K)` table and every CPU tensor
  included: the loss's plain path, `_ce_chunk` chunk by chunk, unchanged.

Counters: `VARIANT_LAUNCHES` counts the calls `chunked_ce_loss` sends down
each route; `LAUNCHES["ce_head"]` counts the kernels launched, two a
forward (`ce_logits_kernel<false>`, `ce_merge_kernel`) and three a chunk
of the backward (`ce_logits_kernel<true>`, dX's and dW's `ce_mm_kernel`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

SOURCE = "ce_head.cu"
ROUTES = ("fused", "plain")
LAUNCHES = {"ce_head": 0}
VARIANT_LAUNCHES = dict.fromkeys(ROUTES, 0)
BLOCK_M = 128                # rows of a CTA's output tile
BLOCK_N = 256                # columns of a CTA's output tile
BLOCK_K = 64                 # contraction a step; K must be a multiple
SMS = 132                    # H100 SXM; the grids aim at 2 CTAs an SM
MAX_GRID_Y = 65535
PLANES = 3


class Plan(NamedTuple):
    """One call: its route, why it is not fused (empty when it is), the
    forward's V splits a row block, the backward's rows a chunk and its
    V splits a row block."""
    route: str
    why: str
    splits: int
    chunk_rows: int
    grad_splits: int


def v_splits(rows: int, V: int) -> int:
    """Splits of V's 256-column tiles a 128-row block, so that about two
    CTAs an SM run: at least 1, at most a tile a split."""
    blocks = -(-rows // BLOCK_M)
    return max(1, min(-(-V // BLOCK_N), round(2 * SMS / blocks)))


def chunk_rows(M: int, K: int) -> int:
    """Rows of D's planes a backward chunk: the chunks equal and a multiple
    of 128, each chunk's planes (3 x 2 bytes a logit) no larger than the
    f32 copy of the head (4 K bytes a column) that the plain path makes,
    which this path never does."""
    cap = max(BLOCK_M, (2 * K // 3) // BLOCK_M * BLOCK_M)
    n = -(-M // cap)
    return -(-(-(-M // n)) // BLOCK_M) * BLOCK_M


@functools.lru_cache(maxsize=1024)
def plan(x_shape: tuple, w_shape: tuple, *, dtypes: tuple, device_type: str,
         row_major: bool, bias: bool) -> Plan:
    """The route of one `chunked_ce_loss` call (module docstring): x
    `(..., K)`, the head as a `(K, V)` matrix, `row_major` whether its
    rows of V are contiguous and 16-byte aligned."""
    K = x_shape[-1]
    M = 1
    for n in x_shape[:-1]:
        M *= n
    V = w_shape[1] if len(w_shape) == 2 else 0
    why = ""
    if device_type != "cuda":
        why = f"tensors on {device_type}"
    elif any(d != torch.bfloat16 for d in dtypes):
        why = "hidden states and head are not both bf16"
    elif bias:
        why = "the head has a bias"
    elif len(w_shape) != 2 or w_shape[0] != K:
        why = f"head {w_shape} for hidden states {x_shape}"
    elif not row_major:
        why = "the head is not a row-major (K, V) matrix (a tied table)"
    elif K % BLOCK_K or V % 8:
        why = f"K {K} not a multiple of {BLOCK_K} or V {V} of 8"
    elif M < 1 or -(-M // BLOCK_M) > MAX_GRID_Y or -(-V // BLOCK_N) > \
            MAX_GRID_Y:
        why = f"{M} rows, V {V}: grid past {MAX_GRID_Y}"
    if why:
        return Plan("plain", why, 0, 0, 0)
    rows = chunk_rows(M, K)
    return Plan("fused", "", v_splits(M, V), rows, v_splits(min(rows, M), V))


def route(x: torch.Tensor, w: torch.Tensor, bias: bool = False) -> Plan:
    """`plan` for hidden states `x` and the head `w` as `(K, V)`."""
    row_major = (w.dim() == 2 and w.stride(1) == 1
                 and w.stride(0) == w.shape[1] and w.data_ptr() % 16 == 0)
    return plan(tuple(x.shape), tuple(w.shape), dtypes=(x.dtype, w.dtype),
                device_type=x.device.type, row_major=row_major, bias=bias)


def count_route(route_name: str) -> None:
    VARIANT_LAUNCHES[route_name] += 1


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def split3(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """f32 `d` as three bf16 terms hi, mid, lo (the kernel's `split3`):
    hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid), each
    residual exact in f32, so hi + mid + lo == d for |d| >= 2^-110 or 0."""
    hi = d.to(torch.bfloat16)
    r = d - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with the four C signatures declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ce_lse.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp, vp, vp, vp,
                           vp]
    lib.ce_grad.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32,
                            vp]
    lib.ce_dx.argtypes = [vp, i64, vp, vp, i32, i32, i32, vp]
    lib.ce_dw.argtypes = [vp, vp, i64, vp, i32, i32, i32, i32, vp]
    for fn in (lib.ce_lse, lib.ce_grad, lib.ce_dx, lib.ce_dw):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def lse(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, p: Plan
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's logZ and NLL (0 where the label is masked), f32:
    `ce_lse`."""
    M, K = x.shape
    V = w.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((2, p.splits, M), **f32)
    label_z = torch.zeros(M, **f32)
    logz, nll = torch.empty(M, **f32), torch.empty(M, **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check("ce_lse", _lib().ce_lse(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), M, K, V, p.splits,
            part[0].data_ptr(), part[1].data_ptr(), label_z.data_ptr(),
            logz.data_ptr(), nll.data_ptr(), stream))
    LAUNCHES["ce_head"] += 2
    return logz, nll


def grads(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
          logz: torch.Tensor, g: torch.Tensor, p: Plan
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """dX and dW for the upstream scalar `g`: chunk by chunk of
    `p.chunk_rows` rows, `ce_grad` writes D's planes, `ce_dx` the chunk's
    rows of dX and `ce_dw` adds to the f32 dW."""
    M, K = x.shape
    V = w.shape[1]
    rows = min(p.chunk_rows, M)
    planes = torch.empty((PLANES, rows, V), dtype=torch.bfloat16,
                         device=x.device)
    plane = rows * V
    g32 = g.detach().float().reshape(1).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((K, V), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, r0 in enumerate(range(0, M, rows)):
            n = min(rows, M - r0)
            xc = x[r0:r0 + n]
            _check("ce_grad", lib.ce_grad(
                xc.data_ptr(), w.data_ptr(), labels[r0:].data_ptr(),
                logz[r0:].data_ptr(), g32.data_ptr(), planes.data_ptr(),
                plane, n, K, V, p.grad_splits, stream))
            LAUNCHES["ce_head"] += 1
            _check("ce_dx", lib.ce_dx(planes.data_ptr(), plane,
                                      w.data_ptr(), dx[r0:].data_ptr(), n, K,
                                      V, stream))
            LAUNCHES["ce_head"] += 1
            _check("ce_dw", lib.ce_dw(xc.data_ptr(), planes.data_ptr(), plane,
                                      dw.data_ptr(), n, K, V, int(i > 0),
                                      stream))
            LAUNCHES["ce_head"] += 1
    del planes                          # before dW's bf16 copy is made
    return dx, dw.to(w.dtype)


class CEHead(torch.autograd.Function):
    """`(sum of NLL over labels >= 0, their count)` of CUDA hidden states
    x `(M, K)`, the head w `(K, V)` and int32 labels `(M,)`, both f32
    scalars.  Saves x, w, the labels and each row's logZ, no logits."""

    @staticmethod
    def forward(ctx, x, w, labels, p):
        logz, nll = lse(x, w, labels, p)
        ctx.save_for_backward(x, w, labels, logz)
        ctx.plan = p
        n_tok = (labels >= 0).sum(dtype=torch.float32)
        ctx.mark_non_differentiable(n_tok)
        return nll.sum(), n_tok

    @staticmethod
    def backward(ctx, g, _):
        x, w, labels, logz = ctx.saved_tensors
        dx, dw = grads(x, w, labels, logz, g, ctx.plan)
        return dx, dw, None, None


def ce_head(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            p: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """`CEHead` over hidden states x `(..., K)` and labels `(...)`."""
    K = x.shape[-1]
    return CEHead.apply(x.reshape(-1, K).contiguous(), w,
                        labels.reshape(-1).to(torch.int32).contiguous(), p)
