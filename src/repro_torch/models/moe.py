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

`dropless=True` (`MoESpec.dropless`, a port-only path: the reference has
none) computes every assignment, with no capacity and no overflow slot:
the same router and top k, then the `T * k` assignments sorted by expert
(a stable sort, so token-major within an expert) and each expert's
offset into them found on the device (`searchsorted`, no host sync);
each expert's rows of x gathered in that order, the SwiGLU experts run as
one grouped product a weight (`kernels.ops.expert_matmul`: on the card a
hand-written grouped GEMM over the experts' 2-bit codes, which reads the
offsets on the device; dense experts a plain loop); the combine gathers
each token's k outputs back through the inverse permutation and sums
them in choice order, weighted, in float32: the weighted scatter-add of
the routed outputs, without atomics, so two runs agree bit for bit, and
one (T, D) term at a time, so it holds no (T, k, D) product.
Under `ternary_packed` its experts are `{"w2", "scale"}` packed codes (an
alpha a layer, expert and column; `models.params.ternary_experts`).

While a profiler records (`repro_torch.trace`), each MoE FFN's routing,
expert products and combine are the spans `moe.route`, `moe.experts`
and `moe.combine` (the caller opens `model.moe` around them), and
`MOE_STATS` counts the calls, their assignments, the assignments dropped
and each call's largest expert load over the mean, kept on the device
until read.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace as TR
from repro_torch.kernels import ops
from repro_torch.kernels.expert_matmul import per_expert


class MoEStats:
    """MoE calls made while a profiler records: their number, the
    assignments routed and dropped, and each call's largest expert load
    over the mean load (kept as device scalars, read by `summary`)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.assignments = 0
        self._dropped: list[torch.Tensor] = []
        self._peak: list[torch.Tensor] = []

    def record(self, counts: torch.Tensor, assignments: int,
               dropped: torch.Tensor) -> None:
        """One call of `assignments` assignments: `counts` (E,) those
        routed to each expert (dropped ones included), `dropped` a device
        scalar."""
        total = counts.sum().float()
        self.calls += 1
        self.assignments += assignments
        self._peak.append(counts.max().float() * counts.numel()
                          / torch.clamp(total, min=1.0))
        self._dropped.append(dropped.reshape(()).float())

    def summary(self) -> dict:
        """`{"calls", "assignments", "dropped", "peak_load"}`, the last a
        list with one entry a call."""
        dropped = int(torch.stack(self._dropped).sum().item()) \
            if self._dropped else 0
        peak = torch.stack(self._peak).cpu().tolist() if self._peak else []
        return {"calls": self.calls, "assignments": self.assignments,
                "dropped": dropped, "peak_load": peak}


MOE_STATS = MoEStats()


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


class Routing(NamedTuple):
    probs: torch.Tensor     # (G, Tg, E) f32 router softmax
    topw: torch.Tensor      # (G, Tg, k) f32 renormalized weights
    tope: torch.Tensor      # (G, Tg, k) int64 experts, best first
    keep: torch.Tensor      # (G, Tg * k) bool: the assignment has a slot
    dst: torch.Tensor       # (G, Tg * k) int64 slot, E * C when dropped


def top_k_experts(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """The router on x (..., D) in float32: `(probs (..., E), topw (...,
    k) renormalized, tope (..., k) best first, ties to the lower
    expert)`."""
    logits = x.float() @ router_w.float()                      # (..., E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = order.values[..., :top_k], order.indices[..., :top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, tope


def route(router_w: torch.Tensor, xg: torch.Tensor, n_experts: int,
          top_k: int, cap: int) -> Routing:
    """Each (token, choice) assignment of `xg` (G, Tg, D) and its slot."""
    E = n_experts
    probs, topw, tope = top_k_experts(router_w, xg, top_k)
    G, Tg, _ = xg.shape
    fe = tope.reshape(G, Tg * top_k)                           # token-major
    onehot = F.one_hot(fe, E)                                  # (G, Tg*k, E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot             # exclusive
    seg_pos = torch.gather(pos_all, -1, fe[..., None])[..., 0]
    keep = seg_pos < cap
    dst = torch.where(keep, fe * cap + seg_pos,
                      torch.full_like(fe, E * cap))            # overflow slot
    return Routing(probs, topw, tope, keep, dst)


def aux_loss(probs: torch.Tensor, tope: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """`E * sum(mean(probs) * mean(onehot(top-1)))` over every token."""
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)                                  # (E,)
    ce = F.one_hot(tope[..., 0], n_experts).float().mean(dim=lead)
    return n_experts * torch.sum(me * ce)


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float, n_groups: int | None = None,
            dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux loss f32 scalar).

    p: router {"w": (D, E)}, experts {"w_gate", "w_up": (E, D, F),
    "w_down": (E, F, D)} (stacked over experts; for `dropless` each may
    be packed `{"w2": (E, K//4, N), "scale": (E, 1, N)}`).
    """
    if dropless:
        return dropless_ffn(p, x, n_experts=n_experts, top_k=top_k)
    B, S, D = x.shape
    T = B * S
    E, k = n_experts, top_k
    G = n_groups if n_groups is not None else 1
    if G < 1 or T % G or (T // G) < 1:
        G = 1
    Tg = T // G
    C = capacity(Tg, E, k, capacity_factor)
    xg = x.reshape(G, Tg, D)
    with TR.span("moe.route"):
        r = route(p["router"]["w"], xg, E, k, C)
        aux = aux_loss(r.probs, r.tope, E)
        if TR.on():
            fe = r.tope.reshape(-1)
            MOE_STATS.record(torch.zeros(E, device=x.device).index_add_(
                0, fe, torch.ones_like(fe, dtype=torch.float32)), T * k,
                (~r.keep).sum())

    with TR.span("moe.experts"):
        # dispatch: each kept assignment's row of x into its slot
        xin = xg.repeat_interleave(k, dim=1)                   # (G, Tg*k, D)
        idx = r.dst[..., None].expand(G, Tg * k, D)
        buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
        buf.scatter_(1, idx, xin)
        eb = buf[:, : E * C].reshape(G, E, C, D)

        # expert FFN (SwiGLU), batched over the expert dim
        ex = p["experts"]
        h = F.silu(torch.einsum("gecd,edf->gecf", eb,
                                ex["w_gate"].to(x.dtype)))
        h = h * torch.einsum("gecd,edf->gecf", eb, ex["w_up"].to(x.dtype))
        out = torch.einsum("gecf,efd->gecd", h, ex["w_down"].to(x.dtype))

    with TR.span("moe.combine"):
        # combine: gather each assignment's slot, weight, sum its k choices
        flat = torch.cat([out.reshape(G, E * C, D),
                          torch.zeros((G, 1, D), dtype=x.dtype,
                                      device=x.device)], dim=1)
        contrib = torch.gather(flat, 1, idx)                   # (G, Tg*k, D)
        contrib = contrib * r.topw.reshape(G, Tg * k)[..., None].to(x.dtype)
        y = contrib.reshape(G, Tg, k, D).sum(dim=2)
    return y.reshape(B, S, D), aux.float()


def expert_matmul(x: torch.Tensor, w, offsets: torch.Tensor
                  ) -> torch.Tensor:
    """Rows `offsets[e]:offsets[e+1]` of x (M, K) times expert e's weight
    -> (M, N) float32.  `w` is packed `{"w2", "scale"}` (the grouped
    ternary kernel, `ops.expert_matmul`) or dense (E, K, N), multiplied a
    expert at a time in x's dtype (the offsets read on the host)."""
    if isinstance(w, dict):
        return ops.expert_matmul(x, w["w2"], w["scale"], offsets)
    return per_expert(x, offsets, w.shape[-1],
                      lambda xe, e: (xe @ w[e].to(x.dtype)).float())


def dropless_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dropless MoE FFN (the module's docstring): x (B, S, D) -> (y
    in x's dtype, aux loss f32 scalar)."""
    B, S, D = x.shape
    T, E, k = B * S, n_experts, top_k
    x2 = x.reshape(T, D)
    with TR.span("moe.route"):
        probs, topw, tope = top_k_experts(p["router"]["w"], x2, k)
        aux = aux_loss(probs, tope, E)
        flat_e = tope.reshape(T * k)                           # token-major
        order = torch.sort(flat_e, stable=True).indices        # by expert
        sorted_e = flat_e[order]
        offsets = torch.searchsorted(
            sorted_e, torch.arange(E + 1, device=x.device)).to(torch.int32)
        xs = x2.index_select(0, order // k)                    # (T*k, D)
        if TR.on():
            MOE_STATS.record(offsets[1:] - offsets[:-1], T * k,
                             torch.zeros((), device=x.device))
    with TR.span("moe.experts"):
        ex = p["experts"]
        h = F.silu(expert_matmul(xs, ex["w_gate"], offsets).to(x.dtype)) \
            * expert_matmul(xs, ex["w_up"], offsets).to(x.dtype)
        out = expert_matmul(h, ex["w_down"], offsets)          # f32
    with TR.span("moe.combine"):
        # each assignment's place in the sorted order, then each token's
        # k outputs weighted and summed in choice order
        place = torch.empty_like(order)
        place[order] = torch.arange(T * k, device=x.device)
        place = place.view(T, k)
        y = out.index_select(0, place[:, 0]) * topw[:, :1]
        for j in range(1, k):
            y.addcmul_(out.index_select(0, place[:, j]), topw[:, j:j + 1])
    return y.to(x.dtype).reshape(B, S, D), aux.float()
