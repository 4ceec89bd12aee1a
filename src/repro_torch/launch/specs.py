"""Inputs and state of every (arch x shape) dry-run cell, on `meta`.

The port of `repro.launch.specs` for one device.  A meta tensor has the
shape and dtype of the real one and no storage, so these stand in for a
cell's batch, decode cache, parameters and optimizer state without
allocating any of them; the reference's `ShapeDtypeStruct`s, leaf for
leaf.  The reference's partition specs (`batch_axes`, `data_size`,
`opt_partition_specs`, `to_shardings`) place these on a mesh; the port
runs on one device and has none.

  * `train_batch_specs(cfg, shape)` — a train or prefill batch: tokens
    [+ labels] (B, S) int32, M-RoPE positions (B, 3, S) int32 and vision
    embeddings (B, Nv, D) bf16 for a VLM, frame embeddings (B, enc_seq,
    D) bf16 for an encoder-decoder;
  * `decode_inputs(cfg, shape)` — a decode step's (cache, tokens (B, 1)
    int32, pos () int32 [, positions (B, 3, 1) int32]);
  * `abstract_state(cfg)` — (params, optimizer state): the parameter
    tree of `models.params.param_defs` and its AdamW state, or the 8-bit
    AdamW state (`Q8Tensor` codes and scales) when `cfg.opt_8bit`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as TF
from repro_torch.models.params import param_defs, tree_map
from repro_torch.optim import adamw, adamw8bit

META = torch.device("meta")


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      with_labels: bool = True) -> dict:
    """The meta batch of a train (or, without labels, prefill) cell."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    if with_labels:
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.rope == "mrope":
        batch["positions"] = _meta((B, 3, S), torch.int32)
        batch["vision_embeds"] = _meta((B, cfg.n_vision_tokens, cfg.d_model),
                                       torch.bfloat16)
    if cfg.enc_layers:
        batch["enc_frames"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """`(cache, tokens, pos[, positions])` of a decode cell on meta: the
    cache for `shape.seq_len` positions of `shape.global_batch` rows."""
    B, S = shape.global_batch, shape.seq_len
    out = (TF.init_cache(cfg, B, S, device=META), _meta((B, 1), torch.int32),
           _meta((), torch.int32))
    if cfg.rope == "mrope":
        out += (_meta((B, 3, 1), torch.int32),)
    return out


def abstract_params(cfg: ModelConfig) -> dict:
    """`param_defs(cfg)` as meta tensors."""
    return tree_map(lambda d: _meta(d.shape, d.dtype), param_defs(cfg))


def abstract_state(cfg: ModelConfig) -> tuple:
    """`(params, optimizer state)` of `cfg` on meta: AdamW, or the 8-bit
    AdamW when `cfg.opt_8bit`."""
    params = abstract_params(cfg)
    opt_mod = adamw8bit if cfg.opt_8bit else adamw
    return params, opt_mod.init(params)
