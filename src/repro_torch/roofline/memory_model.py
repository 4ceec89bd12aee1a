"""Analytic (fusion-aware) HBM traffic model of a step.

The port of `repro.roofline.memory_model`, with the device counts as
arguments: `n_dev` devices, of which `model_shards` split each layer's
weights (the reference writes 256 and 16 into its formulas).  At
`(n_dev=256, model_shards=16)` it gives the reference's numbers term for
term; at `(1, 1)`, the defaults, the traffic of one H100, where no
weight is gathered (the FSDP factor 2, a gather-write plus a read, is 1).

train, per device per step:
    weights  : mb * L * fsdp * W_layer / model_shards
    grads    : mb * L * W_layer / model_shards
    optimizer: (2 * param_bpe + moments_bpe) * P / n_dev
    acts     : mb * L * act_tok * B_mb * S / n_dev
    logits/CE: 2 * B * S * V * 4 / n_dev        (chunk write + read)
    accum    : (2 * mb + 1) * accum_bpe * P / n_dev   (mb > 1)
    encoder  : mb * enc_layers * act_tok * B_mb * enc_seq / n_dev
prefill:
    weights  : L * fsdp * W_layer / model_shards
    acts     : L * act_tok * B * S / n_dev / 2
    logits   : 2 * B * S * V * 4 / n_dev
    cache    : 2 * L * B * min(S, window) * K * dh * bpe / n_dev
decode:
    weights  : gather * W_active / model_shards (2-bit layer weights under
               ternary_packed; gather 2 where serving is FSDP-sharded)
    cache    : the whole cache / n_dev (RWKV: its f32 WKV state)
    acts     : L * act_tok * B / n_dev
    logits   : 2 * B * V * 4 / n_dev

act_tok (bytes/token/layer) counts the remat-boundary stash (2D), the
recomputed MLP/MoE intermediates (2*F_active), attention projections
(4*H*dh) and flash-attention KV reads (amortized) at the compute dtype.
The traced bytes (`roofline.component_costing`) are the eager port's own,
unfused traffic; this model is what a fused step would move.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import leaves, param_count, param_defs

_BPE = {"bfloat16": 2, "float32": 4}


def _tree_bytes(tree: dict) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize
               for _, d in leaves(tree))


def _layer_param_bytes(cfg: ModelConfig) -> float:
    """Full (unsharded) per-layer parameter bytes."""
    return _tree_bytes(param_defs(cfg)["layers"]) / cfg.n_layers


def _active_layer_param_bytes(cfg: ModelConfig) -> tuple[float, float]:
    """(train bytes, decode bytes) a layer touches: an MoE's decode at
    small batch reads about top_k of its E experts."""
    full = _layer_param_bytes(cfg)
    if cfg.moe is None:
        return full, full
    expert_bytes = _tree_bytes(
        param_defs(cfg)["layers"]["moe"]["experts"]) / cfg.n_layers
    dense_rest = full - expert_bytes
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return full, dense_rest + expert_bytes * frac


def _act_token_bytes(cfg: ModelConfig) -> float:
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    F = cfg.d_ff * (cfg.moe.top_k if cfg.moe else 1)
    if cfg.moe and cfg.moe.dense_residual:
        F += cfg.moe.d_ff_dense or cfg.d_ff
    bpe = _BPE[cfg.compute_dtype]
    if cfg.attention_free:
        mix = 6 * D            # r,k,v,g,w streams + wkv state traffic
        return bpe * (2 * D + 2 * cfg.d_ff + mix)
    extra = 0.0
    if cfg.family == "hybrid" and cfg.ssm is not None:
        di = cfg.ssm.expand * D
        extra = 2 * di + 2 * di * cfg.ssm.state_size / 16  # ssm scan traffic
    return bpe * (2 * D + 2 * F + 4 * H * dh + 2 * cfg.n_kv_heads * dh + extra)


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          microbatches: int, n_dev: int = 1,
                          model_shards: int = 1) -> dict:
    """Per-device HBM traffic estimate (bytes) with component breakdown."""
    if n_dev < 1 or model_shards < 1 or n_dev % model_shards:
        raise ValueError(f"n_dev={n_dev} must be a positive multiple of "
                         f"model_shards={model_shards}")
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    V = cfg.vocab
    P_total = param_count(cfg)
    bpe_p = _BPE[cfg.param_dtype]
    W_layer_full, W_layer_active = _active_layer_param_bytes(cfg)
    data_shards = n_dev // model_shards
    # a weight sharded over the data axis is gathered (written) then read
    fsdp = 2.0 if data_shards > 1 else 1.0
    out: dict = {}

    if shape.kind == "train":
        mb = microbatches
        Bm = max(B // mb, 1)
        out["weights"] = mb * L * fsdp * W_layer_full / 1.0 / model_shards
        out["grads"] = mb * L * W_layer_full / model_shards
        moments_bpe = 2 if cfg.opt_8bit else 8
        out["optimizer"] = (2 * bpe_p + moments_bpe) * (P_total / n_dev)
        out["activations"] = mb * L * _act_token_bytes(cfg) * Bm * S / n_dev
        out["logits_ce"] = 2.0 * B * S * V * 4 / n_dev
        acc_bpe = _BPE[cfg.accum_dtype]
        out["grad_accum"] = (mb * 2 + 1) * acc_bpe * (P_total / n_dev) \
            if mb > 1 else 0.0
        if cfg.enc_layers:
            out["encoder"] = (mb * cfg.enc_layers * _act_token_bytes(cfg)
                              * Bm * cfg.enc_seq / n_dev)
    elif shape.kind == "prefill":
        out["weights"] = L * fsdp * W_layer_full / model_shards
        out["activations"] = L * _act_token_bytes(cfg) * B * S / n_dev / 2
        out["logits"] = 2.0 * B * S * V * 4 / n_dev
        out["cache_write"] = (2 * L * B * min(S, cfg.swa_window or S)
                              * cfg.n_kv_heads * cfg.head_dim
                              * _BPE[cfg.compute_dtype] / n_dev)
    else:   # decode
        W_active_total = L * W_layer_active + (P_total * bpe_p
                                               - L * W_layer_full)
        if cfg.quant == "ternary_packed":
            # 2-bit packed layer weights (embeddings/head stay bf16)
            W_active_total = (L * W_layer_active * (0.25 / bpe_p)
                              + (P_total * bpe_p - L * W_layer_full))
        # FSDP-sharded serving re-gathers weights per token (factor 2:
        # gather-write + read); TP-only serving reads the resident shard.
        gather = 2.0 if cfg.serve_fsdp and data_shards > 1 else 1.0
        out["weights"] = gather * W_active_total / n_dev * data_shards
        eff = min(S, cfg.swa_window) if cfg.swa_window else S
        kv_bpe = 1 if cfg.kv_cache_dtype == "float8_e4m3fn" \
            else _BPE[cfg.compute_dtype]
        if cfg.attention_free:
            cache_bytes = L * B * cfg.n_heads * cfg.head_dim ** 2 * 4
        else:
            cache_bytes = 2 * L * B * eff * cfg.n_kv_heads * cfg.head_dim \
                * kv_bpe
            if cfg.enc_layers:
                cache_bytes += 2 * L * B * cfg.enc_seq * cfg.n_kv_heads \
                    * cfg.head_dim * kv_bpe
        out["cache"] = cache_bytes / n_dev
        out["activations"] = L * _act_token_bytes(cfg) * B / n_dev
        out["logits"] = 2.0 * B * V * 4 / n_dev
    out["total"] = sum(out.values())
    return out
