"""Mixture-of-Experts FFN with group-local, dropping token dispatch.

The port of `repro.models.moe` for one device, in the reference's
semantics step for step:

  * the router in float32: softmax over the E experts, the top k taken
    with ties to the lower expert index (as `jax.lax.top_k`), their
    weights renormalized by their sum (floored at 1e-9);
  * the Switch-style load-balancing aux loss `E * sum(mean(probs) *
    mean(onehot(top-1)))`;
  * tokens in G groups (G = 1 unless `n_groups` is given and divides the
    tokens: the reference's default without a mesh); within a group, each
    (token, choice) assignment in token-major order takes the next free
    slot of its expert (an exclusive cumsum of one-hots), and an
    assignment past the capacity C goes to one overflow slot `E * C`,
    which is dropped;
  * SwiGLU experts batched over E (`torch.einsum`, one batched product per
    weight), computed for all `E * C` slots, then the combine gathers
    each assignment's slot back and sums its k weighted outputs.

The experts are plain leaves in the param dtype under every quant, as in
the reference (`moe_ffn` multiplies them raw); they are cast to x's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


class Routing(NamedTuple):
    probs: torch.Tensor     # (G, Tg, E) f32 router softmax
    topw: torch.Tensor      # (G, Tg, k) f32 renormalized weights
    tope: torch.Tensor      # (G, Tg, k) int64 experts, best first
    keep: torch.Tensor      # (G, Tg * k) bool: the assignment has a slot
    dst: torch.Tensor       # (G, Tg * k) int64 slot, E * C when dropped


def route(router_w: torch.Tensor, xg: torch.Tensor, n_experts: int,
          top_k: int, cap: int) -> Routing:
    """Each (token, choice) assignment of `xg` (G, Tg, D) and its slot."""
    E = n_experts
    logits = xg.float() @ router_w.float()                     # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = order.values[..., :top_k], order.indices[..., :top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    G, Tg, _ = xg.shape
    fe = tope.reshape(G, Tg * top_k)                           # token-major
    onehot = F.one_hot(fe, E)                                  # (G, Tg*k, E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot             # exclusive
    seg_pos = torch.gather(pos_all, -1, fe[..., None])[..., 0]
    keep = seg_pos < cap
    dst = torch.where(keep, fe * cap + seg_pos,
                      torch.full_like(fe, E * cap))            # overflow slot
    return Routing(probs, topw, tope, keep, dst)


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float, n_groups: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux loss f32 scalar).

    p: router {"w": (D, E)}, experts {"w_gate", "w_up": (E, D, F),
    "w_down": (E, F, D)} (stacked over experts).
    """
    B, S, D = x.shape
    T = B * S
    E, k = n_experts, top_k
    G = n_groups if n_groups is not None else 1
    if G < 1 or T % G or (T // G) < 1:
        G = 1
    Tg = T // G
    C = capacity(Tg, E, k, capacity_factor)
    xg = x.reshape(G, Tg, D)
    r = route(p["router"]["w"], xg, E, k, C)

    me = r.probs.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(r.tope[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # dispatch: each kept assignment's row of x into its slot
    xin = xg.repeat_interleave(k, dim=1)                       # (G, Tg*k, D)
    idx = r.dst[..., None].expand(G, Tg * k, D)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, idx, xin)
    eb = buf[:, : E * C].reshape(G, E, C, D)

    # expert FFN (SwiGLU), batched over the expert dim
    ex = p["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", eb, ex["w_gate"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", eb, ex["w_up"].to(x.dtype))
    out = torch.einsum("gecf,efd->gecd", h, ex["w_down"].to(x.dtype))

    # combine: gather each assignment's slot, weight, sum its k choices
    flat = torch.cat([out.reshape(G, E * C, D),
                      torch.zeros((G, 1, D), dtype=x.dtype,
                                  device=x.device)], dim=1)
    contrib = torch.gather(flat, 1, idx)                       # (G, Tg*k, D)
    contrib = contrib * r.topw.reshape(G, Tg * k)[..., None].to(x.dtype)
    y = contrib.reshape(G, Tg, k, D).sum(dim=2)
    return y.reshape(B, S, D), aux.float()
