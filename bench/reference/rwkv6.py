"""RWKV-6 ("Finch", arXiv:2404.05892) as the repo's model defines it, in
plain PyTorch.

A layer: x += TimeMix(RMSNorm(x)); x += ChannelMix(RMSNorm(x)).  TimeMix
takes the token shift xx (the previous token, zeros before the first),
five data-dependent lerps sharing one LoRA down-projection A,
`x + (xx - x) * (mu_s + tanh((x + (xx - x) * mu_s) @ A) @ B_s)`, the
projections r, k, v, g = silu(.), the decay w = exp(-exp(w0 + tanh(x_w @
wA) @ wB)) per channel, then per head

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t

an RMS norm of y over d_model with its scale, and (y * g) @ w_o.
ChannelMix: sigmoid(x_r @ w_recv) * (relu(x_k @ w_in)^2 @ w_out) with
plain lerps.  Departures from the paper, all the repo's own model: one
LoRA rank for the lerps and the decay, one shared A, and an RMS norm in
place of the per-head group norm.

`wkv` runs the recurrence exactly, a chunk of `CHUNK` tokens at a time:
inside a chunk every decay product exp(sum of log w) is formed from
cumulative sums that start at the chunk, so nothing is divided by a
decay; `wkv_steps` is the token-by-token definition it is held to.

The module gives the interface `bench/reference/__init__.py` sets out:
the layout, the layer, logits, the loss and the model FLOPs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import roofline, weights
from bench.reference.common import layer_params, logits, rms_norm
from bench.reference.prec import F32

CHUNK = 32


def leaves(model: dict) -> list:
    """The layout: `weights.base_leaves`, then the time mix's and the
    channel mix's leaves."""
    D, F = model["d_model"], model["d_ff"]
    depth, r = model["n_layers"], model["ssm"]["lora_rank"]
    dt = weights.DTYPES[model["param_dtype"]]
    Leaf, proj = weights.Leaf, weights.proj
    tm, cm = ("layers", "tm"), ("layers", "cm")
    down, up = ("normal", 1 / math.sqrt(D)), ("uniform", -0.01, 0.01)
    out = weights.base_leaves(model)
    out += [Leaf(tm + ("lora_A",), (D, r), dt, down, True),
            Leaf(tm + ("w0",), (D,), torch.float32, ("uniform", -6.0, -1.0),
                 True),
            Leaf(tm + ("wA",), (D, r), dt, down, True),
            Leaf(tm + ("wB",), (r, D), dt, up, True),
            Leaf(tm + ("u",), (D,), torch.float32, ("uniform", -0.5, 0.5),
                 True),
            Leaf(tm + ("gn_scale",), (D,), dt, ("one_plus", 0.1), True)]
    for n in ("w_r", "w_k", "w_v", "w_g"):
        out += proj(tm + (n,), D, D, dt)
    out += proj(tm + ("w_o",), D, D, dt, residual_depth=depth)
    for n in ("r", "k", "v", "w", "g"):
        out += [Leaf(tm + (f"mu_{n}",), (D,), dt, ("uniform", 0.0, 1.0), True),
                Leaf(tm + (f"lora_B_{n}",), (r, D), dt, up, True)]
    out += [Leaf(cm + ("mu_k",), (D,), dt, ("uniform", 0.0, 1.0), True),
            Leaf(cm + ("mu_r",), (D,), dt, ("uniform", 0.0, 1.0), True)]
    out += proj(cm + ("w_in",), D, F, dt)
    out += proj(cm + ("w_recv",), D, D, dt)
    out += proj(cm + ("w_out",), F, D, dt, residual_depth=depth)
    return out


def consts(model: dict, S: int, device) -> None:
    """RWKV-6 needs no per-length constants."""
    return None


def wkv_steps(r, k, v, logw, u, s0=None):
    """The recurrence token by token. r, k, v, logw (B, T, H, dh) f32,
    u (H, dh) -> (y (B, T, H, dh), S (B, H, dh, dh)), S[i, j] with i the
    key and j the value channel."""
    B, T, H, dh = r.shape
    S = r.new_zeros(B, H, dh, dh) if s0 is None else s0
    w = torch.exp(logw)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, 1), S


def wkv(r, k, v, logw, u, s0=None, chunk: int = CHUNK):
    """The same recurrence a chunk at a time (see the module notes)."""
    B, T, H, dh = r.shape
    S = r.new_zeros(B, H, dh, dh) if s0 is None else s0
    ys = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, lc = (a[:, c0:c0 + chunk].transpose(1, 2)
                          for a in (r, k, v, logw))          # (B, H, C, dh)
        C = rc.shape[2]
        cum = torch.cumsum(lc, dim=2)                        # log prod w_0..t
        before = cum - lc                                    # log prod w_0..t-1
        # token s's contribution reaches query t > s decayed by
        # prod_{s < tau < t} w_tau = exp(before_t - cum_s)
        later = torch.tril(torch.ones(C, C, dtype=torch.bool,
                                      device=r.device), -1)
        expo = before[:, :, :, None, :] - cum[:, :, None, :, :]
        dec = torch.exp(expo.masked_fill(~later[None, None, :, :, None],
                                         float("-inf")))
        att = torch.einsum("bhti,bhtsi,bhsi->bhts", rc, dec, kc)
        y = att @ vc
        y = y + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) * vc
        y = y + torch.einsum("bhti,bhij->bhtj", rc * torch.exp(before), S)
        tail = torch.exp(cum[:, :, -1:, :] - cum)            # (B, H, C, dh)
        S = torch.exp(cum[:, :, -1, :])[..., None] * S \
            + torch.einsum("bhsi,bhsj->bhij", kc * tail, vc)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1), S


def _shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(p: dict, x: torch.Tensor, n_heads: int, prec=F32):
    B, S, D = x.shape
    dh = D // n_heads
    d = _shift(x) - x
    mm = prec.mm

    def lerp(s):
        mu = p[f"mu_{s}"].float()
        lora = mm(torch.tanh(mm(x + d * mu, p["lora_A"])), p[f"lora_B_{s}"])
        return x + d * (mu + lora)

    xr, xk, xv, xw, xg = (lerp(s) for s in "rkvwg")
    heads = (B, S, n_heads, dh)
    r = mm(xr, p["w_r"]["w"]).view(heads)
    k = mm(xk, p["w_k"]["w"]).view(heads)
    v = mm(xv, p["w_v"]["w"]).view(heads)
    g = prec.q(F.silu(mm(xg, p["w_g"]["w"])))
    wdec = prec.q(p["w0"].float() + mm(torch.tanh(mm(xw, p["wA"])),
                                        p["wB"]))
    logw = -torch.exp(wdec).view(heads)
    y, _ = wkv(prec.q(r), prec.q(k), prec.q(v), logw,
               p["u"].float().view(n_heads, dh))
    y = rms_norm(y.reshape(B, S, D), p["gn_scale"], 1e-5)
    return mm(y * g, p["w_o"]["w"])


def channel_mix(p: dict, x: torch.Tensor, prec=F32):
    d = _shift(x) - x
    xk = x + d * p["mu_k"].float()
    xr = x + d * p["mu_r"].float()
    k = prec.q(torch.square(F.relu(prec.mm(xk, p["w_in"]["w"]))))
    return prec.q(torch.sigmoid(prec.mm(xr, p["w_recv"]["w"]))) \
        * prec.q(prec.mm(k, p["w_out"]["w"]))


def layer(model: dict, lp: dict, x: torch.Tensor, consts=None, prec=F32,
          index: int = 0) -> torch.Tensor:
    """One layer on the stream x (B, S, D); `lp` the layer's leaves (every
    layer alike: `consts` and `index` are not read).  The stream, the
    normed inputs and the mixers' outputs are held in `prec` (exactly, in
    float32) where the program holds them in its compute dtype."""
    eps = model["norm_eps"]
    x = prec.q(x)
    x = prec.q(x + prec.q(time_mix(
        lp["tm"], prec.q(rms_norm(x, lp["ln1"]["scale"], eps)),
        model["n_heads"], prec)))
    return prec.q(x + channel_mix(
        lp["cm"], prec.q(rms_norm(x, lp["ln2"]["scale"], eps)), prec))


def loss(model: dict, params: dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec=F32) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of label NLL, label count) of a batch through every layer of
    `params` (a layer-stacked tree, leaves in float32 or bf16)."""
    x = params["embed"]["tokens"][tokens.long()].float()
    L = params["layers"]["ln1"]["scale"].shape[0]
    for i in range(L):
        x = layer(model, layer_params(params["layers"], i), x, None, prec, i)
    lg = logits(model, params["final_norm"]["scale"], params["lm_head"]["w"],
                x, prec)
    nll = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, labels.long()[..., None])[..., 0]
    return nll.sum(), torch.tensor(float(nll.numel()), device=x.device)


def seq_flops(model: dict, S: int, n_layers: int) -> float:
    """2 a parameter a token, and each layer's time-mixing state products
    (`roofline.wkv_mix_flops`)."""
    n = weights.counts(leaves(model), n_layers)["layers"]
    return roofline.model_flops(n, S, "serve") \
        + n_layers * roofline.wkv_mix_flops(S, model["n_heads"],
                                             model["d_head"])


def ternary_shapes(model: dict, index: int) -> list:
    """No projection: the program serves the RWKV-6 block dense only."""
    return []
