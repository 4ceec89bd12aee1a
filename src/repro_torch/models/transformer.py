"""Model assembly for the dense and RWKV-6 families: forward, prefill and
decode.

The port of `repro.models.transformer` for dense llama-family models and
RWKV-6 on one device.  The reference's `lax.scan` over the layer-stacked
parameters is a Python loop over the leading L axis here, and the decode
cache is updated in place (the reference returns a new cache; the port
writes the step's K/V, or RWKV's shifts and WKV state, into the given one,
which saves a copy of the whole cache per step).  Other families raise
`NotImplementedError` (see ROADMAP.md).

Batch dict keys: tokens (B, S) int64 or int32 [+ positions (B, S)].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (
    apply_rope, embed, layer_norm, linear, rms_norm, rope_cos_sin,
)
from repro_torch.models.params import DTYPES, check_ported, is_rwkv


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _kv_dt(cfg: ModelConfig) -> torch.dtype:
    if cfg.kv_cache_dtype != "compute":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported yet "
            "(fp8 KV is queued in ROADMAP.md)")
    return _cdt(cfg)


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


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(linear(p["w_gate"], x, cfg.quant)) \
            * linear(p["w_up"], x, cfg.quant)
        return linear(p["w_down"], h, cfg.quant)
    h = torch.nn.functional.gelu(linear(p["w_in"], x, cfg.quant),
                                 approximate="tanh")
    return linear(p["w_out"], h, cfg.quant)


def _block_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin):
    a, kv = _attn_full(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), cos, sin,
                       window=cfg.swa_window)
    x = x + a
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return x, kv


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


def _rope_for(cfg: ModelConfig, batch: dict, S: int, device):
    if cfg.rope == "none":
        return None, None
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, device=device)[None, :]
    return rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden (B, S, D), caches | None),
    caches being each layer's (k, v), each (B, S, K, dh), or for RWKV-6
    its (last time-mix input, last channel-mix input, WKV state)."""
    check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"]["tokens"], tokens, _cdt(cfg))
    if is_rwkv(cfg):
        def body(xx, lp):
            return _block_rwkv(cfg, lp, xx)
    else:
        cos, sin = _rope_for(cfg, batch, S, x.device)

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
    kind: str            # attn | rwkv (the kinds ported)
    cache_len: int       # self-attn cache slots (window for SWA); 0 for rwkv


def cache_spec(cfg: ModelConfig, seq_len: int) -> CacheSpec:
    check_ported(cfg)
    if is_rwkv(cfg):
        return CacheSpec("rwkv", 0)
    eff = min(seq_len, cfg.swa_window) if cfg.swa_window else seq_len
    return CacheSpec("attn", eff)


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
               device=None) -> dict:
    """Zero-filled cache sized for `seq_len` context on `device` (an RWKV
    cache holds state, not positions, and ignores `seq_len`)."""
    spec = cache_spec(cfg, seq_len)
    L, B, D = cfg.n_layers, batch_size, cfg.d_model
    if spec.kind == "rwkv":
        dh = cfg.head_dim
        return {"shift_tm": torch.zeros((L, B, D), dtype=_cdt(cfg),
                                        device=device),
                "shift_cm": torch.zeros((L, B, D), dtype=_cdt(cfg),
                                        device=device),
                "wkv": torch.zeros((L, B, cfg.n_heads, dh, dh),
                                   dtype=torch.float32, device=device)}
    shape = (L, B, spec.cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=_kv_dt(cfg), device=device)
            for n in ("k", "v")}


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


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decode step for the whole batch at absolute position `pos`.

    tokens: (B, 1).  Returns (logits (B, 1, V) f32, cache), the cache being
    the one given, updated in place.  An RWKV-6 step reads no position.
    """
    x = embed(params["embed"]["tokens"], tokens, _cdt(cfg))
    if cache_spec(cfg, 0).kind == "rwkv":
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
    Sc = int(cache["k"].shape[2])
    if cfg.rope == "std":
        p1 = torch.full((1, 1), pos, device=dev)
        cos, sin = rope_cos_sin(p1, cfg.head_dim, cfg.rope_theta)
    else:
        cos = sin = None
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
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _norm(cfg, lp["ln1"], x)
        x = x + _attn_decode(cfg, lp["attn"], h, cache["k"][i],
                             cache["v"][i], cos, sin, mask, slot)
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Full-context forward that also builds the decode cache.

    Returns (hidden (B, S, D), cache ready for `decode_step` at pos=S).
    For SWA archs requires S % window == 0 (slot order == position order).
    """
    x, caches = forward(cfg, params, batch, collect_cache=True)
    if is_rwkv(cfg):
        return x, {name: torch.stack([c[n] for c in caches]).contiguous()
                   for n, name in enumerate(SSM.RWKVState._fields)}
    S = x.shape[1]
    Sc = cache_spec(cfg, cache_len).cache_len

    def fit(t: torch.Tensor) -> torch.Tensor:
        # (L, B, S, K, dh) -> (L, B, Sc, K, dh)
        if Sc == S:
            return t
        if Sc < S:     # rolling window: keep the last Sc positions
            if S % Sc:
                raise ValueError("SWA prefill requires S % window == 0")
            return t[:, :, S - Sc:]
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sc - S))

    kvdt = _kv_dt(cfg)
    k = torch.stack([kv[0] for kv in caches])
    v = torch.stack([kv[1] for kv in caches])
    return x, {"k": fit(k).to(kvdt).contiguous(),
               "v": fit(v).to(kvdt).contiguous()}
