"""The kernels on the `meta` device: shapes, dtypes and a report, no data.

A meta tensor has a shape, a dtype and no storage, so a model step run on
meta tensors runs every op of the step and computes nothing
(`roofline.component_costing`, `launch.dryrun`).  The kernel routers send
meta operands here.  Each function allocates what the card path
allocates for the call (its outputs, and a scratch buffer the call
frees on return), returns the outputs with the card path's shapes and
dtypes, and reports the call, with the sizes that price it, to every
sink `recording` has installed.  It is not a fallback: nothing is
computed, so nothing can be computed wrongly.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

Sink = Callable[[str, dict], None]
_SINKS: list[Sink] = []


@contextlib.contextmanager
def recording(sink: Sink):
    """Within the block, `sink(name, sizes)` hears every meta kernel
    call."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def _report(name: str, **sizes) -> None:
    for sink in list(_SINKS):
        sink(name, sizes)


def ternary_matmul(x: torch.Tensor, w2: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """`cuda_ternary_matmul.launch`'s output, `(M, N)` float32.  (Its
    split-K workspace is kept per device across calls, a few MB at most,
    and is not allocated here.)"""
    M, K = x.shape
    N = w2.shape[1]
    _report("ternary_matmul", M=M, K=K, N=N, x_bytes=x.element_size())
    return torch.empty((M, N), dtype=torch.float32, device=x.device)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
               s_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """`cuda_rwkv6_scan.launch` on `(B, T, H, dh)` operands: y `(B, T, H,
    dh)` and the final state `(B, H, dh, dh)` (`s_out` where given),
    float32."""
    B, T, H, dh = r.shape
    if s_out is None:
        s_out = torch.empty((B, H, dh, dh), dtype=torch.float32,
                            device=r.device)
    y = torch.empty((B, T, H, dh), dtype=torch.float32, device=r.device)
    _report("rwkv6_scan", BH=B * H, T=T, dh=dh, with_s0=s0 is not None,
            x_bytes=r.element_size(), u_rows=u.numel() // dh)
    return y, s_out


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                   dy: torch.Tensor, ds: torch.Tensor | None,
                   with_s0: bool) -> tuple:
    """`cuda_rwkv6_scan.launch_bwd`: `(dr, dk, dv, dw, du_rows, ds0)`,
    dr, dk, dv in r's dtype, the rest float32, and its `(B * H, CK * dh *
    dh)` float32 scratch, freed on return."""
    from repro_torch.kernels.rwkv6_scan import CK

    B, T, H, dh = r.shape
    dev = r.device
    dy = dy.to(torch.float32).contiguous()
    if ds is not None:
        ds = ds.to(torch.float32).contiguous()
    shape = (B, T, H, dh)
    dr, dk, dv = (torch.empty(shape, dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    du = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    hist = torch.empty((B * H, CK * dh * dh), dtype=torch.float32, device=dev)
    del hist
    _report("rwkv6_scan_bwd", BH=B * H, T=T, dh=dh, with_s0=with_s0,
            with_ds=ds is not None, x_bytes=r.element_size(),
            u_rows=u.numel() // dh)
    return dr, dk, dv, dw, du, ds0
