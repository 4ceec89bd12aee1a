"""State-space sequence mixers: Mamba (hymba's parallel head) and RWKV-6.

The port of `repro.models.ssm`.

Mamba (selective SSM, diagonal A) is plain PyTorch, as the reference's is
plain JAX: its prefill recurrence `h_t = Abar_t * h_{t-1} + Bu_t` runs as
a loop over the sequence (the reference's `jax.lax.associative_scan`; the
two differ only in float rounding order), decode as one state update.  A
carried-in state enters step 0 as the reference adds it
(`Bu.at[:, 0].add(Abar[:, 0] * h)`), and the conv state is the last
`W - 1` pre-conv inputs.  Unlike the reference's `mamba_forward`, which
zero-pads the causal conv whatever state it is given, the port's reads a
given state's conv inputs as the left context, so a prefill split in two
with the state carried across equals one pass; without a state (the only
way the model calls it) the two agree.

RWKV-6 "Finch": the casts are the reference's: the streams, projections
and decay logits run in the compute dtype, the decay `exp(-exp(.))` is
taken in float32, and so is the WKV recurrence, which goes to
`kernels.ops.rwkv6_scan_heads` (on the card the hand-written kernel) on
the projections' own `(B, S, H, dh)` views, with no copy: r, k and v in
the compute dtype, the decays in float32, the `(H, dh)` bonus shared by
the batch.  The reference runs the same recurrence as a `lax.scan` over
the sequence, which JAX differentiates; where autograd records, the port's
scan runs as `kernels.rwkv6_scan.WKVScan`, whose backward is the
hand-written backward kernel on the card.

Both Mamba's and RWKV-6's projections are dense `w` leaves: the reference
reads them so whatever `cfg.quant` says, and the port serves both dense
only (`models.params.check_ported`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


# ---------------------------------------------------------------------------
# Mamba (selective SSM, diagonal A): hymba's parallel head
# ---------------------------------------------------------------------------
class MambaState(NamedTuple):
    h: torch.Tensor      # (B, d_inner, N) f32
    conv: torch.Tensor   # (B, conv_w - 1, d_inner) the last pre-conv inputs


def _causal_conv(xp: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over a window. xp: (B, W - 1 + S, C), the S
    inputs after the W - 1 before them; w: (W, C); b: (C,) -> (B, S, C)."""
    W = w.shape[0]
    S = xp.shape[1] - (W - 1)
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    return y + b


def _mamba_inner(p: dict, xi: torch.Tensor):
    """dt, B and C of the selective scan from the conv output xi (.., di):
    (dt f32, Bm f32, Cm f32, A (di, N) f32)."""
    dt = xi.dtype
    A = -torch.exp(p["A_log"].float())                         # (di, N)
    delta = F.softplus(xi @ p["w_dt"].to(dt) + p["dt_bias"].to(dt))
    Bm = (xi @ p["w_B"].to(dt)).float()
    Cm = (xi @ p["w_C"].to(dt)).float()
    return delta.float(), Bm, Cm, A


def mamba_forward(p: dict, x: torch.Tensor, state: MambaState | None = None
                  ) -> tuple[torch.Tensor, MambaState]:
    """Full-sequence selective scan. x: (B, S, D) -> ((B, S, D), state)."""
    B, S, D = x.shape
    dt = x.dtype
    xz = x @ p["in_proj"]["w"].to(dt)                          # (B, S, 2*di)
    xi, z = xz.chunk(2, dim=-1)
    W = p["conv_w"].shape[0]
    # the conv's inputs: the state's last W - 1 (zeros without one), then xi
    lead = (torch.zeros_like(xi[:, :1]).expand(-1, W - 1, -1)
            if state is None else state.conv.to(dt))
    window = torch.cat([lead, xi], dim=1)
    xi = F.silu(_causal_conv(window, p["conv_w"].to(dt), p["conv_b"].to(dt)))
    dtf, Bm, Cm, A = _mamba_inner(p, xi)
    Abar = torch.exp(dtf[..., None] * A)                       # (B, S, di, N)
    Bu = (dtf * xi.float())[..., None] * Bm[:, :, None, :]
    h = (torch.zeros_like(Bu[:, 0]) if state is None else state.h)
    hs = []
    # unbound once: autograd then writes each operand's gradient once,
    # where indexing it a step at a time would write a zero-filled copy
    # of the whole (B, S, di, N) operand a step (quadratic in S)
    for a_t, b_t in zip(Abar.unbind(1), Bu.unbind(1)):
        h = a_t * h + b_t
        hs.append(h)
    h_all = torch.stack(hs, dim=1)                             # (B, S, di, N)
    y = torch.einsum("bsdn,bsn->bsd", h_all, Cm)               # (B, S, di)
    y = y + xi.float() * p["d_skip"].float()
    y = y.to(dt) * F.silu(z)
    out = y @ p["out_proj"]["w"].to(dt)
    return out, MambaState(h=h, conv=window[:, S:])


def mamba_decode(p: dict, x: torch.Tensor, state: MambaState
                 ) -> tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, 1, D) -> ((B, 1, D), new state)."""
    dt = x.dtype
    xz = x[:, 0] @ p["in_proj"]["w"].to(dt)
    xi, z = xz.chunk(2, dim=-1)
    window = torch.cat([state.conv.to(dt), xi[:, None, :]], dim=1)
    xi = (window * p["conv_w"].to(dt)[None]).sum(dim=1) + p["conv_b"].to(dt)
    xi = F.silu(xi)
    dtf, Bm, Cm, A = _mamba_inner(p, xi)
    Abar = torch.exp(dtf[:, :, None] * A)                      # (B, di, N)
    h = Abar * state.h + (dtf * xi.float())[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm)
    y = y + xi.float() * p["d_skip"].float()
    y = y.to(dt) * F.silu(z)
    out = (y @ p["out_proj"]["w"].to(dt))[:, None, :]
    return out, MambaState(h=h, conv=window[:, 1:, :])


# ---------------------------------------------------------------------------
# RWKV-6 "Finch": data-dependent decay linear attention
# ---------------------------------------------------------------------------
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
