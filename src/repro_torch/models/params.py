"""Parameter trees of every reference arch: definitions, init and carriers.

The port of `repro.models.params` for a single device: the same tree,
shapes and dtypes as the reference (layer-stacked leaves keep their leading
L axis), no partition specs.  The families: dense (llama, the Qwen archs),
MoE (router and experts beside attention; arctic adds a dense residual
FFN), hybrid (attention and Mamba in parallel), encoder-decoder (whisper's
encoder stack, learned positions and cross-attention), VLM (dense, with
M-RoPE) and RWKV-6.

The projections `_lin` defines carry `ParamDef.lin`: those, and only
those, follow `cfg.quant` (2-bit codes and a scale under
`ternary_packed`).  The MoE router and experts and the Mamba leaves other
than `in_proj` / `out_proj` are plain leaves in every mode, as in the
reference.

  * `init_params` — the reference's initializers from a `torch.Generator`
    (packed projections get all-zero codes, as the reference's do);
  * `quantize_params` — a dense tree's `_lin` leaves quantized per layer
    with `ternary_quantize_lm` and packed, on their device;
  * `serving_params` — serving weights: `init_params` of the dense tree on
    the device, then `quantize_params`, so packed codes are the quantized
    draw, not the all-zero init (the one way the port's entry points,
    tools and tests build weights to serve);
  * `lin_shapes` — the `(K, N)` of every `_lin` projection, the shapes the
    ternary matmul is given under `ternary_packed`;
  * `params_from_reference` — carries a reference tree, given as numpy
    arrays, onto a device leaf by leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ternary import pack_ternary, ternary_quantize_lm
from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"       # normal | zeros | ones
    init_scale: float | None = None
    lin: bool = False          # a `_lin` projection: follows cfg.quant
    experts: bool = False      # an MoE expert stack (L, E, K, N)


def is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" and cfg.ssm is not None \
        and cfg.ssm.kind == "rwkv6"


def is_hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid"


def check_ported(cfg: ModelConfig) -> None:
    """Raise `ValueError` for RWKV-6 or the hybrid with a quantized
    `quant`: the reference's RWKV and Mamba blocks read dense `w` leaves
    whatever `cfg.quant` says, so "ternary" would silently serve dense
    products and "ternary_packed" builds leaves they cannot read (the
    reference raises `KeyError` there).  Every other family runs in every
    mode."""
    if (is_rwkv(cfg) or is_hybrid(cfg)) and cfg.quant != "dense":
        block = "RWKV-6" if is_rwkv(cfg) else "Mamba"
        raise ValueError(
            f"{cfg.name}: the {block} block is dense only (the reference "
            f"ignores quant={cfg.quant!r}); use quant='dense'")


def _lin(cfg: ModelConfig, K: int, N: int, L: int, bias: bool = False
         ) -> dict:
    dt = DTYPES[cfg.param_dtype]
    d: dict = {}
    if cfg.quant == "ternary_packed":
        if K % 4:
            raise ValueError(f"K={K} not packable")
        d["w2"] = ParamDef((L, K // 4, N), torch.int8, "zeros")
        d["scale"] = ParamDef((L, 1, N), torch.float32, "ones")
    else:
        d["w"] = ParamDef((L, K, N), dt, "normal", 1.0 / np.sqrt(K),
                          lin=True)
    if bias:
        d["b"] = ParamDef((L, N), dt, "zeros")
    return d


def _norm_def(cfg: ModelConfig, L: int | None) -> dict:
    dt = DTYPES[cfg.param_dtype]
    shape = (cfg.d_model,) if L is None else (L, cfg.d_model)
    d = {"scale": ParamDef(shape, dt, "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef(shape, dt, "zeros")
    return d


def _rwkv_defs(cfg: ModelConfig, L: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    r = cfg.ssm.lora_rank
    dt = DTYPES[cfg.param_dtype]
    tm = {
        "lora_A": ParamDef((L, D, r), dt, "normal", 1.0 / np.sqrt(D)),
        "w0": ParamDef((L, D), torch.float32, "zeros"),
        "wA": ParamDef((L, D, r), dt, "normal", 1.0 / np.sqrt(D)),
        "wB": ParamDef((L, r, D), dt, "normal", 1.0 / np.sqrt(r)),
        "u": ParamDef((L, D), torch.float32, "zeros"),
        "gn_scale": ParamDef((L, D), dt, "ones"),
        "w_r": _lin(cfg, D, D, L),
        "w_k": _lin(cfg, D, D, L),
        "w_v": _lin(cfg, D, D, L),
        "w_g": _lin(cfg, D, D, L),
        "w_o": _lin(cfg, D, D, L),
    }
    for n in ("r", "k", "v", "w", "g"):
        tm[f"mu_{n}"] = ParamDef((L, D), dt, "zeros")
        tm[f"lora_B_{n}"] = ParamDef((L, r, D), dt, "normal",
                                     1.0 / np.sqrt(r))
    cm = {
        "mu_k": ParamDef((L, D), dt, "zeros"),
        "mu_r": ParamDef((L, D), dt, "zeros"),
        "w_in": _lin(cfg, D, F, L),
        "w_recv": _lin(cfg, D, D, L),
        "w_out": _lin(cfg, F, D, L),
    }
    return {"tm": tm, "cm": cm}


def _attn_defs(cfg: ModelConfig, L: int) -> dict:
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = DTYPES[cfg.param_dtype]
    d = {
        "wq": _lin(cfg, D, H * dh, L, cfg.qkv_bias),
        "wk": _lin(cfg, D, K * dh, L, cfg.qkv_bias),
        "wv": _lin(cfg, D, K * dh, L, cfg.qkv_bias),
        "wo": _lin(cfg, H * dh, D, L),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((L, dh), dt, "ones")
        d["k_norm"] = ParamDef((L, dh), dt, "ones")
    return d


def _mlp_defs(cfg: ModelConfig, L: int, d_ff: int) -> dict:
    D = cfg.d_model
    if cfg.act == "swiglu":
        return {"w_gate": _lin(cfg, D, d_ff, L),
                "w_up": _lin(cfg, D, d_ff, L),
                "w_down": _lin(cfg, d_ff, D, L)}
    return {"w_in": _lin(cfg, D, d_ff, L, True),      # gelu MLP (whisper)
            "w_out": _lin(cfg, d_ff, D, L, True)}


def ternary_experts(cfg: ModelConfig) -> bool:
    """Whether the MoE experts are 2-bit codes: on the dropless path (a
    port-only option) under `ternary_packed`.  The capacity path keeps
    them dense, as the reference's `moe_ffn` does."""
    return cfg.moe is not None and cfg.moe.dropless \
        and cfg.quant == "ternary_packed"


def _moe_defs(cfg: ModelConfig, L: int) -> dict:
    """Router (L, D, E) in float32 and the experts stacked over E in the
    param dtype; plain leaves, dense under every quant (the reference's
    `moe_ffn` multiplies them raw), except on the dropless path under
    `ternary_packed` (`ternary_experts`), where each is packed codes
    `{"w2": (L, E, K//4, N), "scale": (L, E, 1, N)}` (an alpha a layer,
    expert and column)."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    dt = DTYPES[cfg.param_dtype]

    def expert(K: int, N: int):
        if ternary_experts(cfg):
            return {"w2": ParamDef((L, E, K // 4, N), torch.int8, "zeros"),
                    "scale": ParamDef((L, E, 1, N), torch.float32, "ones")}
        return ParamDef((L, E, K, N), dt, "normal", 1.0 / np.sqrt(K),
                        experts=True)

    return {
        "router": {"w": ParamDef((L, D, E), torch.float32, "normal", 0.02)},
        "experts": {"w_gate": expert(D, F), "w_up": expert(D, F),
                    "w_down": expert(F, D)},
    }


def _mamba_defs(cfg: ModelConfig, L: int) -> dict:
    D = cfg.d_model
    di = cfg.ssm.expand * D
    N = cfg.ssm.state_size
    W = cfg.ssm.conv_width
    dt = DTYPES[cfg.param_dtype]
    return {
        "in_proj": _lin(cfg, D, 2 * di, L),
        "conv_w": ParamDef((L, W, di), dt, "normal", 0.2),
        "conv_b": ParamDef((L, di), dt, "zeros"),
        "w_dt": ParamDef((L, di, di), dt, "normal", 1.0 / np.sqrt(di)),
        "dt_bias": ParamDef((L, di), dt, "zeros"),
        "w_B": ParamDef((L, di, N), dt, "normal", 1.0 / np.sqrt(di)),
        "w_C": ParamDef((L, di, N), dt, "normal", 1.0 / np.sqrt(di)),
        "A_log": ParamDef((L, di, N), torch.float32, "zeros"),
        "d_skip": ParamDef((L, di), torch.float32, "ones"),
        "out_proj": _lin(cfg, di, D, L),
    }


def param_defs(cfg: ModelConfig) -> dict:
    """Full parameter tree of `ParamDef` for one architecture."""
    check_ported(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    dt = DTYPES[cfg.param_dtype]
    tree: dict = {
        "embed": {"tokens": ParamDef((V, D), dt, "normal", 0.02)},
        "final_norm": _norm_def(cfg, None),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": ParamDef((D, V), dt, "normal",
                                         1.0 / np.sqrt(D))}
    layer = {"ln1": _norm_def(cfg, L), "ln2": _norm_def(cfg, L)}
    if is_rwkv(cfg):
        tree["layers"] = {**layer, **_rwkv_defs(cfg, L)}
        return tree
    layer["attn"] = _attn_defs(cfg, L)
    if is_hybrid(cfg):
        layer["mamba"] = _mamba_defs(cfg, L)
        layer["attn_out_norm"] = _norm_def(cfg, L)
        layer["mamba_out_norm"] = _norm_def(cfg, L)
    if cfg.moe is not None:
        layer["moe"] = _moe_defs(cfg, L)
        if cfg.moe.dense_residual:
            layer["mlp"] = _mlp_defs(cfg, L, cfg.moe.d_ff_dense or cfg.d_ff)
    else:
        layer["mlp"] = _mlp_defs(cfg, L, cfg.d_ff)
    tree["layers"] = layer
    if cfg.enc_layers:    # whisper's encoder stack and positional tables
        Le = cfg.enc_layers
        tree["enc_layers"] = {"ln1": _norm_def(cfg, Le),
                              "ln2": _norm_def(cfg, Le),
                              "attn": _attn_defs(cfg, Le),
                              "mlp": _mlp_defs(cfg, Le, cfg.d_ff)}
        tree["enc_pos"] = ParamDef((cfg.enc_seq, D), dt, "normal", 0.02)
        tree["dec_pos"] = ParamDef((32768, D), dt, "normal", 0.02)
        tree["enc_final_norm"] = _norm_def(cfg, None)
        layer["xattn"] = _attn_defs(cfg, L)          # cross-attention
        layer["ln_x"] = _norm_def(cfg, L)
    return tree


def leaves(tree: dict, prefix: tuple = ()):
    """`(path, leaf)` pairs in sorted-key order (the reference's flatten
    order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(d.shape)) for _, d in leaves(param_defs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token uses: an MoE's experts count top_k of E."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    experts = sum(int(np.prod(d.shape)) for _, d in
                  leaves(param_defs(cfg)["layers"]["moe"]["experts"]))
    return int(total - experts * (1.0 - cfg.moe.top_k / cfg.moe.n_experts))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Initialized tensors on `device` (None: the current CUDA device).

    One `torch.Generator` seeded with `seed` draws every normal leaf; its
    numbers differ from `jax.random`'s, so tests that compare with the
    reference carry its weights across with `params_from_reference`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        scale = d.init_scale if d.init_scale is not None else 0.02
        return (torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(d.dtype)

    return tree_map(mk, param_defs(cfg))


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)      # a writable copy: torch refuses read-only arrays
    if a.dtype.name == "bfloat16":
        # torch cannot take an ml_dtypes array: move the bit patterns
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: dict, device=None) -> dict:
    """The reference's parameter tree (numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`) as the port's tensors on `device`.

    Keys and shapes are kept as they are; a bf16 leaf (an `ml_dtypes`
    bfloat16 array) is carried by its bit patterns, so every leaf arrives
    bit for bit.
    """
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def _packed(layers) -> dict:
    """A projection's `(K, N)` layers (an `(L, K, N)` stack or any
    iterable of them) quantized one by one (an alpha per layer and
    column) and packed: `{"w2", "scale"}`."""
    codes, scales = [], []
    for w in layers:
        c, alpha = ternary_quantize_lm(w.float())
        codes.append(pack_ternary(c))
        scales.append(alpha.float())
    return {"w2": torch.stack(codes), "scale": torch.stack(scales)}


def quantize_params(cfg: ModelConfig, dense: dict) -> dict:
    """The serving tree of `cfg` from `dense`, a tree of the same arch
    under `quant="dense"`: for `ternary_packed` each `_lin` projection is
    quantized per layer and packed on its own device (its bias kept), and
    with `ternary_experts` each expert stack per layer and expert; every
    other leaf is passed through.  Any other quant returns `dense`.
    """
    if cfg.quant != "ternary_packed":
        return dense
    defs = param_defs(cfg.replace(quant="dense"))
    packed_experts = ternary_experts(cfg)

    def walk(node: dict, dnode: dict) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, dnode[k])
            elif k == "w" and dnode[k].lin:
                out.update(_packed(v))
            elif packed_experts and dnode[k].experts:
                L, E = v.shape[:2]
                out[k] = {n: t.reshape(L, E, *t.shape[1:]) for n, t in
                          _packed(v.flatten(0, 1)).items()}
            else:
                out[k] = v
        return out

    return walk(dense, defs)


def serving_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Serving weights of `cfg` on `device` (None: the current CUDA
    device): the dense tree drawn there by `init_params` from `seed` (a
    host draw of an MoE's billions of normals would take minutes), then
    `quantize_params`, which for `ternary_packed` quantizes and packs each
    `_lin` projection there and leaves every other leaf (the MoE router
    and experts, Mamba's conv and state leaves) as drawn."""
    check_ported(cfg)
    dense = cfg.replace(quant="dense") if cfg.quant == "ternary_packed" \
        else cfg
    return quantize_params(cfg, init_params(dense, seed, device))


def lin_shapes(cfg: ModelConfig) -> set[tuple[int, int]]:
    """`(K, N)` of every projection `_lin` defines in `cfg`'s tree."""
    return {tuple(d.shape[-2:]) for _, d in
            leaves(param_defs(cfg.replace(quant="dense"))) if d.lin}
