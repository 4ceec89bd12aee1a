"""Parameter trees of the dense and RWKV-6 families: definitions, init,
and carriers.

The port of `repro.models.params` for a single device: the same tree,
shapes and dtypes as the reference (layer-stacked leaves keep their leading
L axis), no partition specs.

  * `init_params` — the reference's initializers from a `torch.Generator`
    (packed projections get all-zero codes, as the reference's do);
  * `seeded_params` — serving weights from a numpy seed: each layer's dense
    projection drawn `normal(0, 1/sqrt(K))` and, for `ternary_packed`,
    quantized per layer with `ternary_quantize_lm` and packed;
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


def is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" and cfg.ssm is not None \
        and cfg.ssm.kind == "rwkv6"


def check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for a family the port does not run
    (it runs plain dense and ssm/rwkv6), and `ValueError` for RWKV-6 with
    a quantized `quant`: the reference's RWKV block reads dense `w` leaves
    whatever `cfg.quant` says, so "ternary" would silently serve dense
    products and "ternary_packed" builds leaves it cannot read."""
    if is_rwkv(cfg):
        if cfg.quant != "dense":
            raise ValueError(
                f"{cfg.name}: the RWKV-6 block is dense only (the "
                f"reference ignores quant={cfg.quant!r}); use quant='dense'")
        return
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None \
            or cfg.enc_layers or cfg.frontend is not None \
            or cfg.rope not in ("std", "none"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"ssm={cfg.ssm is not None}, enc_layers={cfg.enc_layers}) is not "
            "ported yet; the port runs the dense and RWKV-6 families — see "
            "ROADMAP.md")


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
        d["w"] = ParamDef((L, K, N), dt, "normal", 1.0 / np.sqrt(K))
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


def param_defs(cfg: ModelConfig) -> dict:
    """Full parameter tree of `ParamDef` for a dense or RWKV-6 config."""
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
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {
        "wq": _lin(cfg, D, H * dh, L, cfg.qkv_bias),
        "wk": _lin(cfg, D, K * dh, L, cfg.qkv_bias),
        "wv": _lin(cfg, D, K * dh, L, cfg.qkv_bias),
        "wo": _lin(cfg, H * dh, D, L),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ParamDef((L, dh), dt, "ones")
        attn["k_norm"] = ParamDef((L, dh), dt, "ones")
    if cfg.act == "swiglu":
        mlp = {"w_gate": _lin(cfg, D, cfg.d_ff, L),
               "w_up": _lin(cfg, D, cfg.d_ff, L),
               "w_down": _lin(cfg, cfg.d_ff, D, L)}
    else:
        mlp = {"w_in": _lin(cfg, D, cfg.d_ff, L, True),
               "w_out": _lin(cfg, cfg.d_ff, D, L, True)}
    tree["layers"] = {**layer, "attn": attn, "mlp": mlp}
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


def seeded_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Serving weights drawn from `numpy.random.default_rng(seed)`.

    Every normal leaf is drawn in float32 in the reference's flatten order
    (embedding `normal(0, 0.02)`, projections `normal(0, 1/sqrt(K))` one
    layer at a time); norms are ones and biases zeros.  For
    `quant="ternary_packed"` each layer's projection goes through
    `ternary_quantize_lm` and `pack_ternary` on `device`, so the codes are
    the quantized weights, not the reference's all-zero init.  Leaves are
    cast to the config's dtypes.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dense = cfg.replace(quant="dense") if cfg.quant == "ternary_packed" \
        else cfg
    out: dict = {}
    for path, d in leaves(param_defs(dense)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if d.init != "normal":
            fill = torch.zeros if d.init == "zeros" else torch.ones
            node[path[-1]] = fill(d.shape, dtype=d.dtype, device=dev)
            continue
        scale = np.float32(d.init_scale if d.init_scale is not None else 0.02)
        packed = cfg.quant == "ternary_packed" and path[0] == "layers"
        layers = []
        for _ in range(d.shape[0] if path[0] == "layers" else 1):
            shape = d.shape[1:] if path[0] == "layers" else d.shape
            w = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)
            if packed:
                codes, alpha = ternary_quantize_lm(w)
                layers.append((pack_ternary(codes), alpha.float()))
            else:
                layers.append(w.to(d.dtype))
        if packed:
            node["w2"] = torch.stack([c for c, _ in layers])
            node["scale"] = torch.stack([a for _, a in layers])
        elif path[0] == "layers":
            node[path[-1]] = torch.stack(layers)
        else:
            node[path[-1]] = layers[0]
    return out
