"""Mellum2 (JetBrains' Mellum2-12B-A2.5B) in plain PyTorch.

A layer: x += Attn(RMSNorm(x)); x += MoE(RMSNorm(x)).  The layer's kind,
`model["layer_types"][index]`, picks its attention and rope:
`sliding_attention` layers see the `swa_window` latest keys (key j seen
by query i where i - window < j <= i) with the default rope,
theta^(-2i/dh); `full_attention` layers are causal with YaRN's rope, by
the formula of HF transformers' `_compute_yarn_parameters`: the
correction dims of `beta_fast` and `beta_slow` rotations over the
original context, dh ln(orig / (2 pi beta)) / (2 ln theta), floored and
ceiled and clamped to [0, dh - 1], a linear ramp between them over the
dh / 2 frequencies blending each from theta^(-2i/dh) (below) to that
over `factor` (above), cos and sin both times `attention_factor`.  Angles
in float64.  Attn: q, k, v, o projections without bias, rope on q and k
(half-split rotation), grouped-query softmax attention (query head h
reads key/value head h // (H/K), scores scaled by dh^-0.5), computed a
block of queries at a time over the keys its mask lets it see.  MoE: a
softmax router in float32 over E experts, the top k taken (a stable
sort: ties to the lower index), their weights renormalized by their
sum; every assignment computed, no capacity: a loop over the experts,
each taking its tokens by `index_select` through a SwiGLU expert,
(silu(x @ Wg) * (x @ Wu)) @ Wd, each output weighted into its token's
choice slot, the k slots summed in choice order.  Under `ternary_packed`
every attention projection and every expert's three matrices is `(x @
codes) * alpha` with the codes and scales of `quant.ternary` derived
here from the dense weights (an alpha a layer, expert and column); the
router, norms, embedding and head stay as drawn.

The module gives the interface `bench/reference/__init__.py` sets out;
it has no loss, so it serves serving cells only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import roofline, weights
from bench.reference.common import logits, rms_norm  # noqa: F401
from bench.reference.prec import F32
from bench.reference.qwen2 import project, rope

QUERY_BLOCK = 1024       # queries an attention block


def leaves(model: dict) -> list:
    """The layout: `weights.base_leaves`, then attention's four
    projections and the MoE's router and expert stacks, every layer
    alike: the router N(0, 0.02), each expert's gate and up N(0, 1/D) and
    down N(0, 1/F) scaled down by sqrt(2 n_layers), as the dense MLP's."""
    D, F_, depth = model["d_model"], model["d_ff"], model["n_layers"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    E = model["moe"]["n_experts"]
    dt = weights.DTYPES[model["param_dtype"]]
    at, moe = ("layers", "attn"), ("layers", "moe")
    out = weights.base_leaves(model)
    out += weights.proj(at + ("wq",), D, H * dh, dt)
    out += weights.proj(at + ("wk",), D, K * dh, dt)
    out += weights.proj(at + ("wv",), D, K * dh, dt)
    out += weights.proj(at + ("wo",), H * dh, D, dt, residual_depth=depth)
    Leaf = weights.Leaf
    down = 1 / math.sqrt(F_) / math.sqrt(2 * depth)
    out += [Leaf(moe + ("router", "w"), (D, E), dt, ("normal", 0.02), True),
            Leaf(moe + ("experts", "w_gate"), (E, D, F_), dt,
                 ("normal", 1 / math.sqrt(D)), True),
            Leaf(moe + ("experts", "w_up"), (E, D, F_), dt,
                 ("normal", 1 / math.sqrt(D)), True),
            Leaf(moe + ("experts", "w_down"), (E, F_, D), dt,
                 ("normal", down), True)]
    return out


def inv_freq(dh: int, spec: dict) -> tuple[torch.Tensor, float]:
    """`(inverse frequencies (dh / 2,) float64, attention factor)` of a
    rope spec (`rope_type` default or yarn)."""
    base = spec["theta"]
    pos_freqs = base ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    if spec.get("rope_type", "default") == "default":
        return 1 / pos_freqs, 1.0
    factor = spec["factor"]
    orig = spec["original_max_position_embeddings"]
    af = spec.get("attention_factor")
    if af is None:
        af = 0.1 * math.log(factor) + 1.0

    def dim(rotations: float) -> float:
        return dh * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(dim(spec["beta_fast"])), 0)
    high = min(math.ceil(dim(spec["beta_slow"])), dh - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dh // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return (1 / (factor * pos_freqs)) * ramp \
        + (1 / pos_freqs) * (1 - ramp), af


def consts(model: dict, S: int, device):
    """Each layer kind's rope tables `(cos, sin)` of S positions."""
    theta = model["rope_theta"]
    specs = {"full_attention": model.get("rope_full"),
             "sliding_attention": model.get("rope_sliding")}
    out = {}
    for kind, spec in specs.items():
        inv, af = inv_freq(model["d_head"], spec or {"theta": theta})
        ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
        out[kind] = ((torch.cos(ang) * af).float().to(device),
                     (torch.sin(ang) * af).float().to(device))
    return out


def attention(q, k, v, window, prec=F32):
    """GQA softmax attention, q (B, S, H, dh), k, v (B, S, K, dh) ->
    (B, S, H, dh): causal, and with a window the `window` latest keys
    only; `QUERY_BLOCK` queries at a time against the keys their mask
    reaches."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    out = torch.empty(B, S, H, dh, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        qb = prec.q(q[:, q0:q1].transpose(1, 2))
        kb = prec.q(k[:, k0:q1].repeat_interleave(G, dim=2).transpose(1, 2))
        vb = prec.q(v[:, k0:q1].repeat_interleave(G, dim=2).transpose(1, 2))
        s = prec.mm(qb, kb.transpose(-1, -2)) * dh ** -0.5
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        seen = kj <= qi
        if window is not None:
            seen &= qi - kj < window
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        out[:, q0:q1] = prec.mm(prec.q(p), vb).transpose(1, 2)
    return out


def attend(model: dict, lp: dict, x: torch.Tensor, tables, window,
           prec=F32):
    """x + Attn(RMSNorm(x)) on the stream x (B, S, D), held in `prec`."""
    B, S, D = x.shape
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    quant, eps = model["quant"], model["norm_eps"]
    a = lp["attn"]
    x = prec.q(x)
    h = prec.q(rms_norm(x, lp["ln1"]["scale"], eps))
    q = prec.q(project(a["wq"], h, quant, prec)).view(B, S, H, dh)
    k = prec.q(project(a["wk"], h, quant, prec)).view(B, S, K, dh)
    v = prec.q(project(a["wv"], h, quant, prec)).view(B, S, K, dh)
    q, k = rope(q, *tables), rope(k, *tables)
    o = attention(q, k, v, window, prec).reshape(B, S, H * dh)
    return prec.q(x + prec.q(project(a["wo"], o, quant, prec)))


def experts(model: dict, p: dict, h: torch.Tensor, prec=F32):
    """The dropless MoE on the normed stream h (B, S, D)."""
    B, S, D = h.shape
    E, k = model["moe"]["n_experts"], model["moe"]["top_k"]
    quant = model["quant"]
    h2 = h.reshape(B * S, D)
    probs = torch.softmax(h2.float() @ p["router"]["w"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = top.values[:, :k], top.indices[:, :k]
    w = w / w.sum(-1, keepdim=True)
    ex = p["experts"]
    slots = torch.zeros(B * S, k, D, dtype=torch.float32, device=h.device)
    for e in range(E):
        tok, choice = (idx == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        xe = h2.index_select(0, tok)
        g = prec.q(F.silu(project({"w": ex["w_gate"][e]}, xe, quant, prec))) \
            * prec.q(project({"w": ex["w_up"][e]}, xe, quant, prec))
        y = project({"w": ex["w_down"][e]}, g, quant, prec)
        slots[tok, choice] = y * w[tok, choice, None]
    return slots.sum(dim=1).view(B, S, D)


def layer(model: dict, lp: dict, x: torch.Tensor, tables, prec=F32,
          index: int = 0):
    """Layer `index` on the f32 stream x (B, S, D); `lp` its dense leaves;
    `tables` `consts`'s rope tables of both kinds."""
    kind = model["layer_types"][index]
    window = model["swa_window"] if kind == "sliding_attention" else None
    x = attend(model, lp, x, tables[kind], window, prec)
    h = prec.q(rms_norm(x, lp["ln2"]["scale"], model["norm_eps"]))
    return prec.q(x + prec.q(experts(model, lp["moe"], h, prec)))


def seq_flops(model: dict, S: int, n_layers: int) -> float:
    """2 for each parameter a token passes (the router, its k experts of
    E), and each layer's score and value products: window pairs on
    windowed layers, causal pairs on full ones
    (`roofline.attention_flops`)."""
    E, k = model["moe"]["n_experts"], model["moe"]["top_k"]
    layout = leaves(model)
    routed = sum(math.prod(lf.shape) * len(weights.present(lf, n_layers))
                 for lf in layout if "experts" in lf.path)
    n = weights.counts(layout, n_layers)["layers"] - routed \
        + routed // E * k
    H, dh = model["n_heads"], model["d_head"]
    attn = 0.0
    for i in range(n_layers):
        window = model["swa_window"] \
            if model["layer_types"][i] == "sliding_attention" else None
        attn += roofline.attention_flops(S, H, dh, window)
    return roofline.model_flops(n, S, "serve") + attn


def ternary_shapes(model: dict, index: int) -> list:
    """The four attention projections of every layer, q, k, v, o (the
    experts go through the grouped kernel)."""
    D = model["d_model"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    return [(D, H * dh), (D, K * dh), (D, K * dh), (H * dh, D)]
