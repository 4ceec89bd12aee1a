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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.prec import F32
from bench.reference.quant import ternary
from bench.reference.rwkv6 import rms_norm


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


def layer(model: dict, lp: dict, x: torch.Tensor, tables, prec=F32):
    """One layer on the f32 stream x (B, S, D); `lp` the layer's dense
    leaves; `tables` the (cos, sin) of `rope_tables`."""
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
    x = prec.q(x + prec.q(project(a["wo"], o, quant, prec)))
    m = lp["mlp"]
    h = prec.q(rms_norm(x, lp["ln2"]["scale"], eps))
    g = prec.q(F.silu(project(m["w_gate"], h, quant, prec))) \
        * prec.q(project(m["w_up"], h, quant, prec))
    return prec.q(x + prec.q(project(m["w_down"], g, quant, prec)))
