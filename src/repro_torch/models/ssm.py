"""RWKV-6 "Finch" mixers: data-dependent decay linear attention.

The port of the RWKV-6 half of `repro.models.ssm` (Mamba comes with the
hybrid slice).  The casts are the reference's: the streams, projections
and decay logits run in the compute dtype, the decay `exp(-exp(.))` is
taken in float32, and so is the WKV recurrence, which goes to
`kernels.ops.rwkv6_scan_heads` (on the card the hand-written kernel) on
the projections' own `(B, S, H, dh)` views, with no copy: r, k and v in
the compute dtype, the decays in float32, the `(H, dh)` bonus shared by
the batch.  The reference runs the same recurrence as a `lax.scan` over
the sequence.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor   # (B, D) previous token (time-mix)
    shift_cm: torch.Tensor   # (B, D) previous token (channel-mix)
    wkv: torch.Tensor        # (B, H, dh, dh) f32 outer-product state


def _shifted(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x (B, S, D) moved one token later, `prev` (or zeros) first."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x, xx, mu, A, Bm):
    """Data-dependent lerp (v6): x + (xx-x) * (mu + tanh((x+(xx-x)*mu)@A)@B).

    Simplified single-stream variant; A: (D, r), Bm: (r, D)."""
    d = xx - x
    lora = torch.tanh((x + d * mu) @ A.to(x.dtype)) @ Bm.to(x.dtype)
    return x + d * (mu + lora)


def rwkv6_timemix(p: dict, x: torch.Tensor, n_heads: int,
                  state: RWKVState | None,
                  wkv_out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, last_x, new_wkv (B, H, dh, dh) f32).

    With `wkv_out`, the new WKV state is written there and returned; it
    may be `state.wkv` (the decode cache updated in place)."""
    B, S, D = x.shape
    dh = D // n_heads
    xx = _shifted(x, None if state is None else state.shift_tm)

    def stream(name):
        return _ddlerp(x, xx, p[f"mu_{name}"].to(x.dtype), p["lora_A"],
                       p[f"lora_B_{name}"])

    xr, xk, xv, xw, xg = (stream(n) for n in ("r", "k", "v", "w", "g"))
    heads = (B, S, n_heads, dh)
    r = (xr @ p["w_r"]["w"].to(x.dtype)).view(heads)
    k = (xk @ p["w_k"]["w"].to(x.dtype)).view(heads)
    v = (xv @ p["w_v"]["w"].to(x.dtype)).view(heads)
    g = F.silu(xg @ p["w_g"]["w"].to(x.dtype))
    # data-dependent decay per channel, in (0, 1)
    wdec = p["w0"].to(x.dtype) + torch.tanh(xw @ p["wA"].to(x.dtype)) \
        @ p["wB"].to(x.dtype)
    wdec = torch.exp(-torch.exp(wdec.float())).view(heads)
    u = p["u"].float().view(n_heads, dh)                       # bonus
    y, s_fin = ops.rwkv6_scan_heads(
        r, k, v, wdec, u, s0=None if state is None else state.wkv,
        s_out=wkv_out)
    # groupnorm ~ rms, as in the reference
    y = rms_norm(y.view(B, S, D).to(x.dtype), p["gn_scale"], eps=1e-5)
    out = (y * g) @ p["w_o"]["w"].to(x.dtype)
    return out, x[:, -1, :], s_fin


def rwkv6_channelmix(p: dict, x: torch.Tensor, state: RWKVState | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    xx = _shifted(x, None if state is None else state.shift_cm)
    xk = x + (xx - x) * p["mu_k"].to(x.dtype)
    xr = x + (xx - x) * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["w_in"]["w"].to(x.dtype)))
    y = torch.sigmoid(xr @ p["w_recv"]["w"].to(x.dtype)) \
        * (k @ p["w_out"]["w"].to(x.dtype))
    return y, x[:, -1, :]
