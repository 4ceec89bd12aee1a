"""Qwen2 (the Qwen2.5 dense family) in plain PyTorch.

A layer: x += Attn(RMSNorm(x)); x += MLP(RMSNorm(x)).  Attn: q, k, v
projections with biases, rotary embedding on q and k (half-split
rotation, frequencies theta^(-2i/dh), angles in float64), grouped-query
causal softmax attention (query head h reads key/value head h // (H/K),
scores scaled by dh^-0.5), the output projection.  MLP: SwiGLU,
(silu(x @ Wg) * (x @ Wu)) @ Wd.  Under `ternary_packed` every projection
is `(x @ codes) * alpha` with the codes and scales of `quant.ternary`
derived here from the dense weights; the biases, norms, embedding and
head stay as drawn.

The module gives the interface `bench/reference/__init__.py` sets out;
it has no loss, so it serves serving cells only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import roofline, weights
from bench.reference.common import logits, rms_norm  # noqa: F401
from bench.reference.prec import F32
from bench.reference.quant import ternary


def leaves(model: dict) -> list:
    """The layout: `weights.base_leaves`, then attention's and the SwiGLU
    MLP's projections, every layer alike."""
    if model["family"] != "dense" or model.get("qk_norm") \
            or model.get("act", "swiglu") != "swiglu":
        raise ValueError(f"{model['name']}: no weight layout for this family")
    D, F_, depth = model["d_model"], model["d_ff"], model["n_layers"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    dt = weights.DTYPES[model["param_dtype"]]
    bias, proj = bool(model.get("qkv_bias")), weights.proj
    at, mlp = ("layers", "attn"), ("layers", "mlp")
    out = weights.base_leaves(model)
    out += proj(at + ("wq",), D, H * dh, dt, bias)
    out += proj(at + ("wk",), D, K * dh, dt, bias)
    out += proj(at + ("wv",), D, K * dh, dt, bias)
    out += proj(at + ("wo",), H * dh, D, dt, residual_depth=depth)
    out += proj(mlp + ("w_gate",), D, F_, dt)
    out += proj(mlp + ("w_up",), D, F_, dt)
    out += proj(mlp + ("w_down",), F_, D, dt, residual_depth=depth)
    return out


def consts(model: dict, S: int, device):
    """The rope tables of S positions."""
    return rope_tables(S, model["d_head"], model["rope_theta"], device)


def rope_tables(S: int, dh: int, theta: float, device):
    pos = torch.arange(S, dtype=torch.float64, device=device)
    freqs = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                    device=device) / dh)
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, dh); cos, sin (S, dh/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def project(p: dict, x: torch.Tensor, quant: str, prec=F32):
    if quant == "ternary_packed":
        codes, alpha = ternary(p["w"])
        y = prec.mm(x, codes) * alpha
    else:
        y = prec.mm(x, p["w"])
    if "b" in p:
        y = y + p["b"].float()
    return y


def attention(q, k, v, prec=F32):
    """Causal GQA: q (B, S, H, dh), k, v (B, S, K, dh) -> (B, S, H, dh)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = prec.mm(prec.q(q.transpose(1, 2)),
                prec.q(k.transpose(1, 2)).transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.mm(prec.q(p), prec.q(v.transpose(1, 2))).transpose(1, 2)


def attend(model: dict, lp: dict, x: torch.Tensor, tables, prec=F32):
    """x + Attn(RMSNorm(x)) on the stream x (B, S, D), held in `prec`;
    `lp` the layer's leaves, `tables` the (cos, sin) of `rope_tables`."""
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
    o = attention(q, k, v, prec).reshape(B, S, H * dh)
    return prec.q(x + prec.q(project(a["wo"], o, quant, prec)))


def layer(model: dict, lp: dict, x: torch.Tensor, tables, prec=F32,
          index: int = 0):
    """One layer on the f32 stream x (B, S, D); `lp` the layer's dense
    leaves; `tables` the (cos, sin) of `rope_tables` (`consts`); every
    layer alike, `index` is not read."""
    quant, eps = model["quant"], model["norm_eps"]
    x = attend(model, lp, x, tables, prec)
    m = lp["mlp"]
    h = prec.q(rms_norm(x, lp["ln2"]["scale"], eps))
    g = prec.q(F.silu(project(m["w_gate"], h, quant, prec))) \
        * prec.q(project(m["w_up"], h, quant, prec))
    return prec.q(x + prec.q(project(m["w_down"], g, quant, prec)))


def seq_flops(model: dict, S: int, n_layers: int) -> float:
    """2 a parameter a token, and each layer's causal score and value
    products (`roofline.attention_flops`)."""
    n = weights.counts(leaves(model), n_layers)["layers"]
    return roofline.model_flops(n, S, "serve") \
        + n_layers * roofline.attention_flops(S, model["n_heads"],
                                              model["d_head"])


def ternary_shapes(model: dict, index: int) -> list:
    """The seven projections of every layer, q, k, v, o, gate, up, down."""
    D, F_ = model["d_model"], model["d_ff"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    return [(D, H * dh), (D, K * dh), (D, K * dh), (H * dh, D),
            (D, F_), (D, F_), (F_, D)]
