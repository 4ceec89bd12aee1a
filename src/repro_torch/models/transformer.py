"""Model assembly for every reference arch: forward, prefill and decode.

The port of `repro.models.transformer` on one device.  The reference's
`lax.scan` over the layer-stacked parameters is a Python loop over the
leading L axis here, and the decode cache is updated in place (the
reference returns a new cache; the port writes the step's K/V, the Mamba
state, or RWKV's shifts and WKV state into the given one, which saves a
copy of the whole cache per step).  The families:

  * dense (llama, the Qwen archs: QKV bias, qk-norm, a decoupled head_dim,
    tied embeddings) and MoE (`models.moe`; arctic adds a dense residual
    FFN in parallel), with sliding-window attention where the config has
    it;
  * hybrid (hymba): attention and a Mamba head on the same normed input,
    their normed outputs averaged;
  * encoder-decoder (whisper): an encoder stack over the frame embeddings
    plus learned positions, then decoder layers with cross-attention over
    the encoder's output (its K/V cached once at prefill);
  * VLM (qwen2-vl): M-RoPE positions (B, 3, S) and vision embeddings
    written over the first `n_vision_tokens` positions;
  * RWKV-6.

Batch dict keys: tokens (B, S) int64 or int32 [+ positions (B, S), or
(B, 3, S) for M-RoPE] [+ vision_embeds (B, Nv, D) for a VLM] [+ enc_frames
(B, enc_seq, D) for an encoder-decoder].  The KV cache is stored in the
compute dtype or, with `kv_cache_dtype="float8_e4m3fn"`, in fp8 (written
by a cast, read back to float32), as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (
    apply_rope, embed, layer_norm, linear, mrope_cos_sin, rms_norm,
    rope_cos_sin,
)
from repro_torch.models.params import DTYPES, check_ported, is_hybrid, \
    is_rwkv


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


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """The layer's FFN on the normed input: the MLP, or the MoE (plus
    arctic's dense residual MLP in parallel)."""
    if cfg.moe is None:
        return _mlp(cfg, lp["mlp"], h)
    y, _ = MOE.moe_ffn(lp["moe"], h, n_experts=cfg.moe.n_experts,
                       top_k=cfg.moe.top_k,
                       capacity_factor=cfg.moe.capacity_factor)
    if cfg.moe.dense_residual:
        y = y + _mlp(cfg, lp["mlp"], h)
    return y


def _block_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin):
    a, kv = _attn_full(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), cos, sin,
                       window=cfg.swa_window)
    x = x + a
    return x + _ffn(cfg, lp, _norm(cfg, lp["ln2"], x)), kv


def _block_hybrid(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin):
    h = _norm(cfg, lp["ln1"], x)
    a, kv = _attn_full(cfg, lp["attn"], h, cos, sin, window=cfg.swa_window)
    m, mstate = SSM.mamba_forward(lp["mamba"], h)
    x = x + 0.5 * (_norm(cfg, lp["attn_out_norm"], a)
                   + _norm(cfg, lp["mamba_out_norm"], m))
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return x, (kv, mstate)


def _block_rwkv(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                state: SSM.RWKVState | None = None,
                wkv_out: torch.Tensor | None = None):
    h = _norm(cfg, lp["ln1"], x)
    tm_out, last_tm, wkv = SSM.rwkv6_timemix(lp["tm"], h, cfg.n_heads, state,
                                             wkv_out)
    x = x + tm_out
    h2 = _norm(cfg, lp["ln2"], x)
    cm_out, last_cm = SSM.rwkv6_channelmix(lp["cm"], h2, state)
    return x + cm_out, (last_tm, last_cm, wkv)


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
    o = ATT.blockwise_attention(q, xk, xv, causal=False,
                                block_k=cfg.attn_block_k)
    x = x + linear(lp["xattn"]["wo"], o.reshape(B, S, H * dh), cfg.quant)
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return x, (kv, (xk, xv))


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


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden (B, S, D), caches | None),
    caches being each layer's (k, v), each (B, S, K, dh); for the hybrid
    ((k, v), MambaState), for the encoder-decoder ((k, v), (xk, xv)), for
    RWKV-6 (last time-mix input, last channel-mix input, WKV state)."""
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
    if is_rwkv(cfg):
        def body(xx, lp):
            return _block_rwkv(cfg, lp, xx)
    else:
        cos, sin = _rope_for(cfg, batch, S, B, x.device)
        if cfg.enc_layers:
            enc = batch["enc_frames"].to(comp) \
                + params["enc_pos"][None].to(comp)
            for i in range(cfg.enc_layers):
                enc = _block_enc(cfg, _layer(params["enc_layers"], i), enc)
            enc_out = _norm(cfg, params["enc_final_norm"], enc)
            x = x + params["dec_pos"][:S][None].to(comp)

            def body(xx, lp):
                return _block_dec_xattn(cfg, lp, xx, enc_out, cos, sin)
        elif is_hybrid(cfg):
            def body(xx, lp):
                return _block_hybrid(cfg, lp, xx, cos, sin)
        else:
            def body(xx, lp):
                return _block_dense(cfg, lp, xx, cos, sin)
    caches = []
    for i in range(cfg.n_layers):
        x, entry = body(x, _layer(params["layers"], i))
        if collect_cache:
            caches.append(entry)
    x = _norm(cfg, params["final_norm"], x)
    return x, (caches if collect_cache else None)


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       x: torch.Tensor) -> torch.Tensor:
    """f32 logits.  Tied embeddings: `x.float() @ table.float().T`, which
    costs no cast when the table is already float32 (the serving engine
    keeps one such copy)."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["tokens"].float().T
    return linear(params["lm_head"], x.float(), "dense")


# ---------------------------------------------------------------------------
# Decode: cache init + single step
# ---------------------------------------------------------------------------
class CacheSpec(NamedTuple):
    kind: str            # attn | hybrid | rwkv | encdec
    cache_len: int       # self-attn cache slots (window for SWA); 0 for rwkv


def cache_spec(cfg: ModelConfig, seq_len: int) -> CacheSpec:
    check_ported(cfg)
    if is_rwkv(cfg):
        return CacheSpec("rwkv", 0)
    eff = min(seq_len, cfg.swa_window) if cfg.swa_window else seq_len
    if is_hybrid(cfg):
        return CacheSpec("hybrid", eff)
    if cfg.enc_layers:
        return CacheSpec("encdec", eff)
    return CacheSpec("attn", eff)


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
                 positions: torch.Tensor | None):
    if cfg.rope == "mrope":
        p3 = positions if positions is not None else \
            torch.full((B, 3, 1), pos, device=device)
        return mrope_cos_sin(p3, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    if cfg.rope == "std":
        return rope_cos_sin(torch.full((1, 1), pos, device=device),
                            cfg.head_dim, cfg.rope_theta)
    return None, None


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
    kind = cache_spec(cfg, 0).kind
    if kind == "rwkv":
        for i in range(cfg.n_layers):
            st = SSM.RWKVState(cache["shift_tm"][i], cache["shift_cm"][i],
                               cache["wkv"][i])
            # the WKV state is updated in place; the token shifts copied
            x, (last_tm, last_cm, _) = _block_rwkv(
                cfg, _layer(params["layers"], i), x, st, wkv_out=st.wkv)
            cache["shift_tm"][i] = last_tm
            cache["shift_cm"][i] = last_cm
        x = _norm(cfg, params["final_norm"], x)
        return logits_from_hidden(cfg, params, x), cache
    dev = x.device
    B = x.shape[0]
    Sc = int(cache["k"].shape[2])
    cos, sin = _decode_rope(cfg, pos, B, dev, positions)
    rolling = cfg.swa_window is not None and Sc == cfg.swa_window
    if rolling:
        slot, mask = ATT.rolling_slot(pos, Sc), ATT.rolling_mask(pos, Sc, dev)
    else:
        if not 0 <= pos < Sc:
            # the reference's dynamic_update_slice would clamp the slot to
            # Sc - 1 and overwrite the last entry; refuse instead
            raise ValueError(f"decode position {pos} is outside the cache "
                             f"of {Sc} slots")
        slot, mask = pos, ATT.linear_mask(pos, Sc, dev)
    if kind == "encdec":
        x = x + params["dec_pos"][pos:pos + 1][None].to(comp)
        all_enc = torch.ones(cache["xk"].shape[2], dtype=torch.bool,
                             device=dev)
    H, dh = cfg.n_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _norm(cfg, lp["ln1"], x)
        a = _attn_decode(cfg, lp["attn"], h, cache["k"][i], cache["v"][i],
                         cos, sin, mask, slot)
        if kind == "hybrid":
            m, st = SSM.mamba_decode(lp["mamba"], h, SSM.MambaState(
                cache["mamba_h"][i], cache["mamba_conv"][i]))
            cache["mamba_h"][i] = st.h
            cache["mamba_conv"][i] = st.conv
            a = 0.5 * (_norm(cfg, lp["attn_out_norm"], a)
                       + _norm(cfg, lp["mamba_out_norm"], m))
        x = x + a
        if kind == "encdec":
            hq = _norm(cfg, lp["ln_x"], x)
            q = linear(lp["xattn"]["wq"], hq, cfg.quant).reshape(B, 1, H, dh)
            xo = ATT.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                      all_enc)
            x = x + linear(lp["xattn"]["wo"], xo.reshape(B, 1, H * dh),
                           cfg.quant)
        x = x + _ffn(cfg, lp, _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Full-context forward that also builds the decode cache.

    Returns (hidden (B, S, D), cache ready for `decode_step` at pos=S),
    K/V cast to the KV dtype.  For SWA archs requires S % window == 0 when
    S exceeds the window (slot order == position order).
    """
    x, caches = forward(cfg, params, batch, collect_cache=True)
    if is_rwkv(cfg):
        return x, {name: torch.stack([c[n] for c in caches]).contiguous()
                   for n, name in enumerate(SSM.RWKVState._fields)}
    S = x.shape[1]
    spec = cache_spec(cfg, cache_len)
    Sc = spec.cache_len

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
    return x, out
