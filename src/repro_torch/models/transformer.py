"""Model assembly for every reference arch: forward, prefill and decode.

The port of `repro.models.transformer` on one device.  The reference's
`lax.scan` over the layer-stacked parameters is a Python loop over the
leading L axis here, and the decode cache is updated in place (the
reference returns a new cache; the port writes the step's K/V, the Mamba
state, or RWKV's shifts and WKV state into the given one, which saves a
copy of the whole cache per step).  The families:

  * dense (llama, the Qwen archs: QKV bias, qk-norm, a decoupled head_dim,
    tied embeddings) and MoE (`models.moe`; arctic adds a dense residual
    FFN in parallel; mellum routes dropless), with sliding-window attention
    where the config has it: in every layer, or, with `cfg.layer_types`,
    in the `sliding_attention` layers only, each layer kind with its own
    rope (`cfg.layer_rope`: default or YaRN);
  * hybrid (hymba): attention and a Mamba head on the same normed input,
    their normed outputs averaged;
  * encoder-decoder (whisper): an encoder stack over the frame embeddings
    plus learned positions, then decoder layers with cross-attention over
    the encoder's output (its K/V cached once at prefill);
  * VLM (qwen2-vl): M-RoPE positions (B, 3, S) and vision embeddings
    written over the first `n_vision_tokens` positions;
  * RWKV-6.

Every layer runs through one of the standalone per-layer entry points,
the reference's `apply_block` (full sequence) and `apply_block_decode`
(a decode step), which `roofline.component_costing` costs one at a time;
the full-sequence stack unbinds its stacked weights once, so a backward
pass writes each stack's gradient once.

Training: `loss_fn` is the reference's objective, the mean label NLL from
`chunked_ce_loss` (the (B, S, V) logits computed S-chunk by S-chunk) plus
`MOE_AUX_COEF` times the MoE load-balancing loss `forward` carries; with
`cfg.remat` each layer is recomputed in the backward pass.  On the card,
a bf16 model with an untied head computes the loss on the tensor cores
(`kernels.cuda_ce_head`), and no logits reach device memory.  While a
profiler records, each attention call (scores, mask, softmax, values) is
the span `model.attention` (attr `window`: the layer's window, or None),
each MoE FFN `model.moe`, and the loss's forward and backward are
`model.loss` and `model.loss.backward` (`repro_torch.trace`).

Batch dict keys: tokens (B, S) int64 or int32 [+ labels (B, S), pad =
-1, for the loss] [+ positions (B, S), or
(B, 3, S) for M-RoPE] [+ vision_embeds (B, Nv, D) for a VLM] [+ enc_frames
(B, enc_seq, D) for an encoder-decoder].  The KV cache is stored in the
compute dtype or, with `kv_cache_dtype="float8_e4m3fn"`, in fp8 (written
by a cast, read back to float32), as the reference does.  A model whose
layers mix window and full attention keeps the two kinds side by side:
`k` / `v` stack its full layers' caches (`cache_len` slots) and `k_win` /
`v_win` its windowed layers' (a rolling cache of `min(cache_len,
window)` slots), each layer at its place among the layers of its kind.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import trace as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import cuda_ce_head as CH
from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (
    apply_rope, embed, layer_norm, linear, mrope_cos_sin, rms_norm,
    rope_cos_sin, rope_spec_cos_sin,
)
from repro_torch.models.params import DTYPES, check_ported, is_hybrid, \
    is_rwkv

MOE_AUX_COEF = 0.01


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _kv_dt(cfg: ModelConfig) -> torch.dtype:
    """KV-cache storage dtype: the compute dtype, or fp8 (math stays f32).
    The reference treats an unknown name as "compute"; the port raises."""
    if cfg.kv_cache_dtype == "compute":
        return _cdt(cfg)
    if cfg.kv_cache_dtype == "float8_e4m3fn":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}; use "
                     "'compute' or 'float8_e4m3fn'")


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters: every stacked leaf indexed on its L axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n layers' parameters, every stacked leaf unbound along its L
    axis once.  Autograd then writes a stack's gradient once; indexed a
    layer at a time, each layer's gradient would be a zero-filled copy of
    the whole stack, accumulated: traffic quadratic in the depth."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x, cfg.quant).reshape(B, S, H, dh)
    k = linear(p["wk"], x, cfg.quant).reshape(B, S, K, dh)
    v = linear(p["wv"], x, cfg.quant).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_full(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin, *,
               causal: bool = True, window: int | None = None):
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    with TR.span("model.attention", window=window):
        o = ATT.blockwise_attention(q, k, v, causal=causal, window=window,
                                    block_k=cfg.attn_block_k)
    out = linear(p["wo"], o.reshape(B, S, H * dh), cfg.quant)
    return out, (k, v)


def _cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """Cross-attention K/V of the encoder output: (B, Se, K, dh) each."""
    B, Se, _ = enc_out.shape
    K, dh = cfg.n_kv_heads, cfg.head_dim
    k = linear(p["wk"], enc_out, cfg.quant).reshape(B, Se, K, dh)
    v = linear(p["wv"], enc_out, cfg.quant).reshape(B, Se, K, dh)
    return k, v


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu" and "w_gate" in p:
        h = torch.nn.functional.silu(linear(p["w_gate"], x, cfg.quant)) \
            * linear(p["w_up"], x, cfg.quant)
        return linear(p["w_down"], h, cfg.quant)
    h = torch.nn.functional.gelu(linear(p["w_in"], x, cfg.quant),
                                 approximate="tanh")
    return linear(p["w_out"], h, cfg.quant)


def _zero(x: torch.Tensor) -> torch.Tensor:
    """A layer's aux loss where it has no MoE: a float32 zero."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor):
    """The layer's FFN on the normed input: the MLP, or the MoE (plus
    arctic's dense residual MLP in parallel).  Returns `(y, aux)`, aux
    the MoE's load-balancing loss (zero without one)."""
    if cfg.moe is None:
        return _mlp(cfg, lp["mlp"], h), _zero(h)
    with TR.span("model.moe"):
        y, aux = MOE.moe_ffn(lp["moe"], h, n_experts=cfg.moe.n_experts,
                             top_k=cfg.moe.top_k,
                             capacity_factor=cfg.moe.capacity_factor,
                             dropless=cfg.moe.dropless)
    if cfg.moe.dense_residual:
        y = y + _mlp(cfg, lp["mlp"], h)
    return y, aux


# Full-sequence blocks return (x, aux, cache entry), as the reference's.
def _block_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin,
                 window: int | None):
    a, kv = _attn_full(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), cos, sin,
                       window=window)
    x = x + a
    y, aux = _ffn(cfg, lp, _norm(cfg, lp["ln2"], x))
    return x + y, aux, kv


def _block_hybrid(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin,
                  window: int | None):
    h = _norm(cfg, lp["ln1"], x)
    a, kv = _attn_full(cfg, lp["attn"], h, cos, sin, window=window)
    m, mstate = SSM.mamba_forward(lp["mamba"], h)
    x = x + 0.5 * (_norm(cfg, lp["attn_out_norm"], a)
                   + _norm(cfg, lp["mamba_out_norm"], m))
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return x, _zero(x), (kv, mstate)


def _block_rwkv(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                state: SSM.RWKVState | None = None,
                wkv_out: torch.Tensor | None = None):
    h = _norm(cfg, lp["ln1"], x)
    tm_out, last_tm, wkv = SSM.rwkv6_timemix(lp["tm"], h, cfg.n_heads, state,
                                             wkv_out)
    x = x + tm_out
    h2 = _norm(cfg, lp["ln2"], x)
    cm_out, last_cm = SSM.rwkv6_channelmix(lp["cm"], h2, state)
    return x + cm_out, _zero(x), (last_tm, last_cm, wkv)


def _block_enc(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    a, _ = _attn_full(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), None, None,
                      causal=False)
    x = x + a
    return x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))


def _block_dec_xattn(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                     enc_out: torch.Tensor, cos, sin):
    a, kv = _attn_full(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), cos, sin)
    x = x + a
    xk, xv = _cross_kv(cfg, lp["xattn"], enc_out)
    hq = _norm(cfg, lp["ln_x"], x)
    B, S, _ = hq.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q = linear(lp["xattn"]["wq"], hq, cfg.quant).reshape(B, S, H, dh)
    with TR.span("model.attention"):
        o = ATT.blockwise_attention(q, xk, xv, causal=False,
                                    block_k=cfg.attn_block_k)
    x = x + linear(lp["xattn"]["wo"], o.reshape(B, S, H * dh), cfg.quant)
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return x, _zero(x), (kv, (xk, xv))


def apply_block(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                cos=None, sin=None, enc_out: torch.Tensor | None = None,
                index: int | None = None):
    """One full-sequence layer (the stack's body), standalone: `(x, aux,
    cache entry)`.  The reference's `apply_block`; `forward` runs every
    layer through it and `roofline.component_costing` costs one.  `index`
    (the absolute layer) picks the attention window where the layers'
    kinds differ (`cfg.layer_window`)."""
    window = cfg.layer_window(index)
    if is_rwkv(cfg):
        return _block_rwkv(cfg, lp, x)
    if is_hybrid(cfg):
        return _block_hybrid(cfg, lp, x, cos, sin, window)
    if cfg.enc_layers and enc_out is not None:
        return _block_dec_xattn(cfg, lp, x, enc_out, cos, sin)
    return _block_dense(cfg, lp, x, cos, sin, window)


def layer_body(cfg: ModelConfig, *, cos=None, sin=None,
               enc_out: torch.Tensor | None = None,
               ropes: dict | None = None):
    """`_stack`'s body `(x, lp, i) -> (x, aux, entry)` for decoder layers:
    `apply_block` of layer i with the step's rope tables (`ropes`, by
    layer kind, where the kinds have their own) and encoder output."""
    def body(x, lp, i):
        c, s = (cos, sin) if ropes is None else ropes[cfg.layer_kind(i)]
        return apply_block(cfg, lp, x, cos=c, sin=s, enc_out=enc_out,
                           index=i)
    return body


def encoder_body(cfg: ModelConfig):
    """`_stack`'s body for encoder layers (whisper)."""
    def body(x, lp, i):
        return _block_enc(cfg, lp, x), _zero(x), None
    return body


def _rope_for(cfg: ModelConfig, batch: dict, S: int, B: int, device):
    if cfg.rope == "none":
        return None, None
    pos = batch.get("positions")
    if cfg.rope == "mrope":
        if pos is None:
            pos = torch.arange(S, device=device)[None, None, :].expand(B, 3, S)
        return mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    if pos is None:
        pos = torch.arange(S, device=device)[None, :]
    return rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def _kind_ropes(cfg: ModelConfig, pos: torch.Tensor) -> dict:
    """`{layer kind: (cos, sin)}` at `pos` (..., S), each kind's own rope
    (`cfg.layer_rope`)."""
    return {kind: rope_spec_cos_sin(pos, cfg.head_dim, cfg.layer_rope(kind))
            for kind in sorted(set(cfg.layer_types))}


def _stack(cfg: ModelConfig, layers: dict, n: int, x: torch.Tensor, body,
           collect_cache: bool):
    """`body(x, lp, i) -> (x, aux, entry)` over n stacked layers: the
    reference's scan.  With `cfg.remat`, where autograd records, each
    layer runs under `torch.utils.checkpoint` (the reference's
    `jax.checkpoint` on the scanned body): its activations are
    recomputed in the backward pass, which changes memory only.  Returns
    (x, summed aux, entries | None)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux, caches = _zero(x), []
    for i, lp in enumerate(_unstack(layers, n)):
        if remat:
            x, aux_l, entry = torch.utils.checkpoint.checkpoint(
                body, x, lp, i, use_reentrant=False)
        else:
            x, aux_l, entry = body(x, lp, i)
        aux = aux + aux_l
        if collect_cache:
            caches.append(entry)
    return x, aux, (caches if collect_cache else None)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden (B, S, D), aux, caches |
    None): aux the layers' summed MoE load-balancing loss (a float32
    scalar, 0 without MoE), caches each layer's (k, v), each (B, S, K,
    dh); for the hybrid ((k, v), MambaState), for the encoder-decoder
    ((k, v), (xk, xv)), for RWKV-6 (last time-mix input, last channel-mix
    input, WKV state)."""
    check_ported(cfg)
    comp = _cdt(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"]["tokens"], tokens, comp)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"]
        if ve.shape[1] > S:
            # the reference's dynamic_update_slice cannot place them
            raise ValueError(f"{cfg.name}: a prompt of {S} tokens is shorter "
                             f"than its {ve.shape[1]} vision embeddings")
        x = torch.cat([ve.to(comp), x[:, ve.shape[1]:]], dim=1)
    cos = sin = enc_out = ropes = None
    if cfg.layer_types:
        pos = batch.get("positions")
        ropes = _kind_ropes(cfg, torch.arange(S, device=x.device)[None, :]
                            if pos is None else pos)
    elif not is_rwkv(cfg):
        cos, sin = _rope_for(cfg, batch, S, B, x.device)
        if cfg.enc_layers:
            enc = batch["enc_frames"].to(comp) \
                + params["enc_pos"][None].to(comp)
            enc, _, _ = _stack(cfg, params["enc_layers"], cfg.enc_layers,
                               enc, encoder_body(cfg), False)
            enc_out = _norm(cfg, params["enc_final_norm"], enc)
            x = x + params["dec_pos"][:S][None].to(comp)
    body = layer_body(cfg, cos=cos, sin=sin, enc_out=enc_out, ropes=ropes)
    # a depth-0 tree (the costing's embedding and head alone) has no stack
    layers = params["layers"] if cfg.n_layers else {}
    x, aux, caches = _stack(cfg, layers, cfg.n_layers, x, body,
                            collect_cache)
    x = _norm(cfg, params["final_norm"], x)
    return x, aux, caches


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       x: torch.Tensor) -> torch.Tensor:
    """f32 logits.  Tied embeddings: `x.float() @ table.float().T`, which
    costs no cast when the table is already float32 (the serving engine
    keeps one such copy)."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["tokens"].float().T
    return linear(params["lm_head"], x.float(), "dense")


def _ce_chunk(cfg: ModelConfig, params: dict, xc: torch.Tensor,
              lc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (sum of label NLL, label count): f32 logits, logZ by
    `logsumexp`, labels < 0 masked out."""
    logits = logits_from_hidden(cfg, params, xc)             # (B, Sc, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(lc, min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(torch.float32)
    return ((logz - ll) * mask).sum(), mask.sum()


def chunked_ce_loss(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    labels: torch.Tensor, n_chunks: int = 8
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over S chunks, so the (B, S, V) logits never exist
    at once: `n_chunks` lowered until it divides S, as the reference
    lowers it, each chunk's logits in f32.  With `cfg.remat`, where
    autograd records, each chunk runs under `torch.utils.checkpoint`, so
    the backward pass too holds one chunk's logits at a time.  Returns
    (sum of NLL over labels >= 0, their count), both f32 scalars.

    A bf16 call on the card with an untied head takes the fused route
    (`kernels.cuda_ce_head`): the head's products on the tensor cores and
    no logits in device memory, the same function at f32 precision.

    While a profiler records, the forward is the span `model.loss`, and
    a hook on `x` closes the open `model.loss.backward` (which
    `train.loop.grads_of` begins) once x's gradient is whole: the
    chunks' backward and their recompute lie inside it."""
    if TR.on() and torch.is_grad_enabled() and x.requires_grad:
        # the loss's backward ends where the gradient of x is whole
        x.register_hook(TR.closer("model.loss.backward"))
    if cfg.tie_embeddings:
        w, bias = params["embed"]["tokens"].T, False
    else:
        w, bias = params["lm_head"]["w"], "b" in params["lm_head"]
    p = CH.route(x, w, bias)
    CH.count_route(p.route)
    if p.route == "fused":
        with TR.span("model.loss"):
            return CH.ce_head(x, w, labels, p)
    B, S, _ = x.shape
    n_chunks = max(1, min(n_chunks, S))
    while S % n_chunks:
        n_chunks -= 1
    Sc = S // n_chunks
    remat = cfg.remat and torch.is_grad_enabled()
    with TR.span("model.loss"):
        nll = n_tok = _zero(x)
        for c in range(n_chunks):
            xc = x[:, c * Sc:(c + 1) * Sc]
            lc = labels[:, c * Sc:(c + 1) * Sc]
            if remat:
                part, cnt = torch.utils.checkpoint.checkpoint(
                    _ce_chunk, cfg, params, xc, lc, use_reentrant=False)
            else:
                part, cnt = _ce_chunk(cfg, params, xc, lc)
            nll, n_tok = nll + part, n_tok + cnt
    return nll, n_tok


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Scalar LM loss and metrics (the train step's objective): the mean
    label NLL plus `MOE_AUX_COEF` times the summed MoE aux loss.  Returns
    (loss, {"loss", "nll", "tokens", "moe_aux"})."""
    x, aux, _ = forward(cfg, params, batch)
    nll, n_tok = chunked_ce_loss(cfg, params, x, batch["labels"])
    loss = nll / torch.clamp(n_tok, min=1.0) + MOE_AUX_COEF * aux
    return loss, {"loss": loss, "nll": nll, "tokens": n_tok, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode: cache init + single step
# ---------------------------------------------------------------------------
class CacheSpec(NamedTuple):
    kind: str            # attn | hybrid | rwkv | encdec
    cache_len: int       # self-attn cache slots (window for SWA); 0 for rwkv


def cache_spec(cfg: ModelConfig, seq_len: int) -> CacheSpec:
    """The cache's kind and slots (of the full layers where window and
    full layers mix: `window_slots` gives the windowed layers')."""
    check_ported(cfg)
    if is_rwkv(cfg):
        return CacheSpec("rwkv", 0)
    eff = min(seq_len, cfg.swa_window) \
        if cfg.swa_window and not cfg.mixed_attention else seq_len
    if is_hybrid(cfg):
        return CacheSpec("hybrid", eff)
    if cfg.enc_layers:
        return CacheSpec("encdec", eff)
    return CacheSpec("attn", eff)


def window_slots(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a windowed layer's cache where window and full layers
    mix: the window, or `seq_len` when that is shorter."""
    return min(seq_len, cfg.swa_window)


def _kind_layers(cfg: ModelConfig, kind: str) -> list[int]:
    """The absolute layers of one kind, in order."""
    return [i for i in range(cfg.n_layers) if cfg.layer_kind(i) == kind]


def layer_cache(cfg: ModelConfig, cache: dict, i: int) -> dict:
    """Layer i's cache entries: views into the model's cache."""
    if not cfg.mixed_attention or "k" not in cache:
        return _layer(cache, i)
    kind = cfg.layer_kind(i)
    j = _kind_layers(cfg, kind).index(i)
    win = kind == "sliding_attention"
    return {"k": cache["k_win" if win else "k"][j],
            "v": cache["v_win" if win else "v"][j]}


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
               device=None) -> dict:
    """Zero-filled cache sized for `seq_len` context on `device` (an RWKV
    cache holds state, not positions, and ignores `seq_len`)."""
    spec = cache_spec(cfg, seq_len)
    L, B, D = cfg.n_layers, batch_size, cfg.d_model
    comp = _cdt(cfg)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if spec.kind == "rwkv":
        dh = cfg.head_dim
        return {"shift_tm": zeros((L, B, D), comp),
                "shift_cm": zeros((L, B, D), comp),
                "wkv": zeros((L, B, cfg.n_heads, dh, dh), torch.float32)}
    K, dh, kvdt = cfg.n_kv_heads, cfg.head_dim, _kv_dt(cfg)
    if cfg.mixed_attention and spec.kind == "attn":
        nw = len(_kind_layers(cfg, "sliding_attention"))
        W = window_slots(cfg, seq_len)
        return {"k": zeros((L - nw, B, spec.cache_len, K, dh), kvdt),
                "v": zeros((L - nw, B, spec.cache_len, K, dh), kvdt),
                "k_win": zeros((nw, B, W, K, dh), kvdt),
                "v_win": zeros((nw, B, W, K, dh), kvdt)}
    c = {n: zeros((L, B, spec.cache_len, K, dh), kvdt) for n in ("k", "v")}
    if spec.kind == "hybrid":
        di = cfg.ssm.expand * D
        c["mamba_h"] = zeros((L, B, di, cfg.ssm.state_size), torch.float32)
        c["mamba_conv"] = zeros((L, B, cfg.ssm.conv_width - 1, di), comp)
    if spec.kind == "encdec":
        c["xk"] = zeros((L, B, cfg.enc_seq, K, dh), kvdt)
        c["xv"] = zeros((L, B, cfg.enc_seq, K, dh), kvdt)
    return c


def _attn_decode(cfg, lp, x, cache_k, cache_v, cos, sin, mask, slot: int):
    """One layer's decode attention; writes the step's K/V at `slot` of
    this layer's cache views in place."""
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, lp, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    o = ATT.decode_attention(q, cache_k, cache_v, mask)
    return linear(lp["wo"], o.reshape(B, 1, H * dh), cfg.quant)


def _decode_rope(cfg: ModelConfig, pos: int, B: int, device,
                 positions: torch.Tensor | None, kind: str | None = None):
    if kind is not None:
        return rope_spec_cos_sin(torch.full((1, 1), pos, device=device),
                                 cfg.head_dim, cfg.layer_rope(kind))
    if cfg.rope == "mrope":
        p3 = positions if positions is not None else \
            torch.full((B, 3, 1), pos, device=device)
        return mrope_cos_sin(p3, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    if cfg.rope == "std":
        return rope_cos_sin(torch.full((1, 1), pos, device=device),
                            cfg.head_dim, cfg.rope_theta)
    return None, None


def apply_block_decode(cfg: ModelConfig, lp: dict, cl: dict,
                       x: torch.Tensor, pos: int, cos, sin, mask, slot,
                       xmask):
    """One decode-step layer (the decode loop's body), standalone: `cl`
    holds this layer's cache entries (views into the model's cache), which
    the step updates in place; the other arguments are
    `decode_context`'s.  Returns `(x, cl)`.  The reference's
    `apply_block_decode`; `decode_step` runs every layer through it and
    `roofline.component_costing` costs one."""
    kind = cache_spec(cfg, 0).kind
    if kind == "rwkv":
        st = SSM.RWKVState(cl["shift_tm"], cl["shift_cm"], cl["wkv"])
        # the WKV state is updated in place; the token shifts copied
        x, _, (last_tm, last_cm, _) = _block_rwkv(cfg, lp, x, st,
                                                  wkv_out=st.wkv)
        cl["shift_tm"].copy_(last_tm)
        cl["shift_cm"].copy_(last_cm)
        return x, cl
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    h = _norm(cfg, lp["ln1"], x)
    a = _attn_decode(cfg, lp["attn"], h, cl["k"], cl["v"], cos, sin, mask,
                     slot)
    if kind == "hybrid":
        m, st = SSM.mamba_decode(lp["mamba"], h, SSM.MambaState(
            cl["mamba_h"], cl["mamba_conv"]))
        cl["mamba_h"].copy_(st.h)
        cl["mamba_conv"].copy_(st.conv)
        a = 0.5 * (_norm(cfg, lp["attn_out_norm"], a)
                   + _norm(cfg, lp["mamba_out_norm"], m))
    x = x + a
    if kind == "encdec":
        hq = _norm(cfg, lp["ln_x"], x)
        q = linear(lp["xattn"]["wq"], hq, cfg.quant).reshape(B, 1, H, dh)
        xo = ATT.decode_attention(q, cl["xk"], cl["xv"], xmask)
        x = x + linear(lp["xattn"]["wo"], xo.reshape(B, 1, H * dh),
                       cfg.quant)
    x = x + _ffn(cfg, lp, _norm(cfg, lp["ln2"], x))[0]
    return x, cl


def decode_context(cfg: ModelConfig, cache: dict, pos: int, B: int, device,
                   positions: torch.Tensor | None = None,
                   layer_kind: str | None = None):
    """What every layer (of `layer_kind`, where `cfg.layer_types` gives
    the layers' kinds) of a decode step at `pos` shares: `(cos, sin,
    mask, slot, xmask)`, the rope tables, the self-attention mask and the
    cache slot the step writes, and the cross-attention mask of an
    encoder-decoder (None elsewhere; all None for RWKV-6)."""
    kind = cache_spec(cfg, 0).kind
    if kind == "rwkv":
        return None, None, None, None, None
    win = layer_kind == "sliding_attention" and "k_win" in cache
    Sc = int(cache["k_win" if win else "k"].shape[2])
    cos, sin = _decode_rope(cfg, pos, B, device, positions, layer_kind)
    window = cfg.kind_window(layer_kind)
    rolling = window is not None and Sc == window
    if rolling:
        slot = ATT.rolling_slot(pos, Sc)
        mask = ATT.rolling_mask(pos, Sc, device)
    else:
        if not 0 <= pos < Sc:
            # the reference's dynamic_update_slice would clamp the slot to
            # Sc - 1 and overwrite the last entry; refuse instead
            raise ValueError(f"decode position {pos} is outside the cache "
                             f"of {Sc} slots")
        slot, mask = pos, ATT.linear_mask(pos, Sc, device)
    xmask = None
    if kind == "encdec":
        xmask = torch.ones(cache["xk"].shape[2], dtype=torch.bool,
                           device=device)
    return cos, sin, mask, slot, xmask


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int,
                positions: torch.Tensor | None = None):
    """One decode step for the whole batch at absolute position `pos`.

    tokens: (B, 1); positions: M-RoPE ids (B, 3, 1), default `pos` in all
    three streams.  Returns (logits (B, 1, V) f32, cache), the cache being
    the one given, updated in place.  An RWKV-6 step reads no position.
    """
    comp = _cdt(cfg)
    x = embed(params["embed"]["tokens"], tokens, comp)
    ctx = {kind: decode_context(cfg, cache, pos, x.shape[0], x.device,
                                positions, kind)
           for kind in sorted(set(cfg.layer_types)) or [None]}
    if cfg.enc_layers:
        x = x + params["dec_pos"][pos:pos + 1][None].to(comp)
    for i in range(cfg.n_layers):
        x, _ = apply_block_decode(cfg, _layer(params["layers"], i),
                                  layer_cache(cfg, cache, i), x, pos,
                                  *ctx[cfg.layer_kind(i)])
    x = _norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Full-context forward that also builds the decode cache.

    Returns (hidden (B, S, D), cache ready for `decode_step` at pos=S),
    K/V cast to the KV dtype.  For SWA archs requires S % window == 0 when
    S exceeds the window (slot order == position order); the windowed
    layers of a model that mixes window and full layers take any S.
    """
    x, _, caches = forward(cfg, params, batch, collect_cache=True)
    return x, assemble_cache(cfg, caches, x.shape[1], cache_len)


def assemble_cache(cfg: ModelConfig, caches: list, S: int,
                   cache_len: int) -> dict:
    """The decode cache from `forward`'s per-layer entries of an S-token
    prefill: each entry stacked along a leading layer axis (the K/V fitted
    to `cache_len` slots and cast to the KV dtype)."""
    if is_rwkv(cfg):
        return {name: torch.stack([c[n] for c in caches]).contiguous()
                for n, name in enumerate(SSM.RWKVState._fields)}
    spec = cache_spec(cfg, cache_len)
    Sc = spec.cache_len
    if cfg.mixed_attention and spec.kind == "attn":
        return _assemble_mixed(cfg, caches, S, cache_len)

    def fit(t: torch.Tensor) -> torch.Tensor:
        # (L, B, S, K, dh) -> (L, B, Sc, K, dh)
        if Sc == S:
            return t
        if Sc < S:     # rolling window: keep the last Sc positions
            if S % Sc:
                raise ValueError("SWA prefill requires S % window == 0")
            return t[:, :, S - Sc:]
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sc - S))

    def stacked(entries, dtype) -> torch.Tensor:
        return torch.stack(list(entries)).to(dtype).contiguous()

    kvdt = _kv_dt(cfg)
    kvs = caches if spec.kind == "attn" else [c[0] for c in caches]
    out = {"k": fit(torch.stack([kv[0] for kv in kvs])).to(kvdt).contiguous(),
           "v": fit(torch.stack([kv[1] for kv in kvs])).to(kvdt).contiguous()}
    if spec.kind == "hybrid":
        out["mamba_h"] = stacked((c[1].h for c in caches), torch.float32)
        out["mamba_conv"] = stacked((c[1].conv for c in caches), _cdt(cfg))
    if spec.kind == "encdec":
        out["xk"] = stacked((c[1][0] for c in caches), kvdt)
        out["xv"] = stacked((c[1][1] for c in caches), kvdt)
    return out


def _assemble_mixed(cfg: ModelConfig, caches: list, S: int,
                    cache_len: int) -> dict:
    """`assemble_cache` where window and full layers mix: the full layers'
    K/V padded to `cache_len` slots, the windowed layers' last `W =
    window_slots` positions with position p at slot p % W (the rolling
    cache's order), or padded when S is shorter."""
    kvdt = _kv_dt(cfg)
    W = window_slots(cfg, cache_len)

    def full(t: torch.Tensor) -> torch.Tensor:     # (B, S, K, dh)
        if cache_len < S:
            raise ValueError(f"a prefill of {S} tokens does not fit a cache "
                             f"of {cache_len} slots")
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cache_len - S))

    def rolling(t: torch.Tensor) -> torch.Tensor:
        if S <= W:
            return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, W - S))
        return torch.roll(t[:, S - W:], shifts=S % W, dims=1)

    out = {}
    for kind, fit, suffix in (("full_attention", full, ""),
                              ("sliding_attention", rolling, "_win")):
        idx = _kind_layers(cfg, kind)
        for n, name in enumerate(("k", "v")):
            out[name + suffix] = torch.stack(
                [fit(caches[i][n]) for i in idx]).to(kvdt).contiguous()
    return out
