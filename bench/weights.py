"""The weights every cell runs, drawn by the benchmark from `--seed`.

Both sides get the same values: the program as its parameter tree (the
port's layout: layer-stacked leaves with a leading L axis, projections as
`{"w": (K, N)}`), the reference a layer at a time, drawn again.  Each
(leaf, layer) has a generator of its own, seeded from (run seed, leaf
path, layer), so any layer is drawn alone without the others; the draws
run on the device in one call per (leaf, layer), in float32, scaled, and
are stored in the leaf's dtype.

Inits: projections N(0, 1/K), and those that write into the residual
stream (RWKV's w_o and w_out, attention's wo, the MLP's w_down) scaled
down by sqrt(2 n_layers) with n_layers the published depth (GPT-2's
residual scaling); RWKV's LoRA down-projections N(0, 1/d_model) and
up-projections U(-0.01, 0.01), its decay base w0 U(-6, -1) (RWKV-6's own
ranges: its up-projections start at U(-0.01, 0.01), its decay base
between -6 and -1) and bonus u U(-0.5, 0.5); token shifts mu U(0, 1);
norm scales 1 + N(0, 0.1); QKV biases N(0, 0.1); the embedding
N(0, 0.02); the head N(0, 1/d_model).  With up-projections of N(0, 1/r)
instead, the data-dependent decays and lerps make a 32-layer RWKV-6
chaotic: a bf16-sized change of its input moves the float32 reference's
logits as far as bf16 compute does (2.1 against 3.0, at a logit spread
of 1.0), and no comparison could tell bf16 from a lower precision.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Leaf:
    path: tuple            # keys from the root of the tree
    shape: tuple           # one layer's shape (the whole leaf if not stacked)
    dtype: torch.dtype
    init: tuple            # ("normal", std) | ("uniform", lo, hi) | ("one_plus", std)
    stacked: bool


def is_rwkv(model: dict) -> bool:
    return (model.get("ssm") or {}).get("kind") == "rwkv6"


def _proj(path, K, N, dt, bias=False, residual_depth=0):
    std = 1 / math.sqrt(K)
    if residual_depth:
        std /= math.sqrt(2 * residual_depth)
    out = [Leaf(path + ("w",), (K, N), dt, ("normal", std), True)]
    if bias:
        out.append(Leaf(path + ("b",), (N,), dt, ("normal", 0.1), True))
    return out


def leaves(model: dict) -> list[Leaf]:
    """Every leaf of the dense tree of `model` (a configuration file's
    `model` entry), in a fixed order."""
    D, F, V = model["d_model"], model["d_ff"], model["vocab"]
    depth = model["n_layers"]
    dt = DTYPES[model["param_dtype"]]
    f32 = torch.float32
    out = [Leaf(("embed", "tokens"), (V, D), dt, ("normal", 0.02), False),
           Leaf(("final_norm", "scale"), (D,), dt, ("one_plus", 0.1), False)]
    if model.get("tie_embeddings"):
        raise ValueError("tied embeddings are not drawn by this benchmark")
    out.append(Leaf(("lm_head", "w"), (D, V), dt,
                    ("normal", 1 / math.sqrt(D)), False))
    L = ("layers",)
    for n in ("ln1", "ln2"):
        out.append(Leaf(L + (n, "scale"), (D,), dt, ("one_plus", 0.1), True))
    if is_rwkv(model):
        r = model["ssm"]["lora_rank"]
        tm, cm = L + ("tm",), L + ("cm",)
        down, up = ("normal", 1 / math.sqrt(D)), ("uniform", -0.01, 0.01)
        out += [Leaf(tm + ("lora_A",), (D, r), dt, down, True),
                Leaf(tm + ("w0",), (D,), f32, ("uniform", -6.0, -1.0), True),
                Leaf(tm + ("wA",), (D, r), dt, down, True),
                Leaf(tm + ("wB",), (r, D), dt, up, True),
                Leaf(tm + ("u",), (D,), f32, ("uniform", -0.5, 0.5), True),
                Leaf(tm + ("gn_scale",), (D,), dt, ("one_plus", 0.1), True)]
        for n in ("w_r", "w_k", "w_v", "w_g"):
            out += _proj(tm + (n,), D, D, dt)
        out += _proj(tm + ("w_o",), D, D, dt, residual_depth=depth)
        for n in ("r", "k", "v", "w", "g"):
            out += [Leaf(tm + (f"mu_{n}",), (D,), dt, ("uniform", 0.0, 1.0),
                         True),
                    Leaf(tm + (f"lora_B_{n}",), (r, D), dt, up, True)]
        out += [Leaf(cm + ("mu_k",), (D,), dt, ("uniform", 0.0, 1.0), True),
                Leaf(cm + ("mu_r",), (D,), dt, ("uniform", 0.0, 1.0), True)]
        out += _proj(cm + ("w_in",), D, F, dt)
        out += _proj(cm + ("w_recv",), D, D, dt)
        out += _proj(cm + ("w_out",), F, D, dt, residual_depth=depth)
        return out
    if model["family"] != "dense" or model.get("qk_norm") \
            or model.get("act", "swiglu") != "swiglu":
        raise ValueError(f"{model['name']}: no weight layout for this family")
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    bias = bool(model.get("qkv_bias"))
    at, mlp = L + ("attn",), L + ("mlp",)
    out += _proj(at + ("wq",), D, H * dh, dt, bias)
    out += _proj(at + ("wk",), D, K * dh, dt, bias)
    out += _proj(at + ("wv",), D, K * dh, dt, bias)
    out += _proj(at + ("wo",), H * dh, D, dt, residual_depth=depth)
    out += _proj(mlp + ("w_gate",), D, F, dt)
    out += _proj(mlp + ("w_up",), D, F, dt)
    out += _proj(mlp + ("w_down",), F, D, dt, residual_depth=depth)
    return out


def leaf_seed(seed: int, path: tuple, layer: int | None) -> int:
    key = f"{seed}/{'/'.join(path)}/{layer}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") >> 1


def draw_leaf(leaf: Leaf, seed: int, device, layer: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's values of `leaf` (the whole leaf if not stacked)."""
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, leaf.path, layer))
    kind = leaf.init[0]
    if kind == "uniform":
        lo, hi = leaf.init[1:]
        x = torch.rand(leaf.shape, generator=gen, device=device)
        x.mul_(hi - lo).add_(lo)
    else:
        x = torch.randn(leaf.shape, generator=gen, device=device)
        x.mul_(leaf.init[1])
        if kind == "one_plus":
            x.add_(1.0)
    if out is None:
        return x.to(leaf.dtype)
    out.copy_(x)
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(model: dict, seed: int, device, n_layers: int) -> dict:
    """The dense parameter tree of `n_layers` layers (layers 0 ..
    n_layers - 1) on `device`."""
    tree: dict = {}
    for leaf in leaves(model):
        if leaf.stacked:
            t = torch.empty((n_layers, *leaf.shape), dtype=leaf.dtype,
                            device=device)
            for i in range(n_layers):
                draw_leaf(leaf, seed, device, i, out=t[i])
        else:
            t = draw_leaf(leaf, seed, device)
        _put(tree, leaf.path, t)
    return tree


def draw_layer(model: dict, seed: int, device, layer: int) -> dict:
    """Layer `layer`'s leaves, the `layers` subtree without its L axis."""
    tree: dict = {}
    for leaf in leaves(model):
        if leaf.stacked:
            _put(tree, leaf.path[1:], draw_leaf(leaf, seed, device, layer))
    return tree


def draw_top(model: dict, seed: int, device, name: str) -> torch.Tensor:
    """A leaf outside the layers by its dotted path (`embed.tokens`,
    `final_norm.scale`, `lm_head.w`)."""
    path = tuple(name.split("."))
    leaf, = [lf for lf in leaves(model) if lf.path == path]
    return draw_leaf(leaf, seed, device)


def param_counts(model: dict, n_layers: int) -> dict:
    """Parameters of the tree by part: `layers` (all `n_layers`),
    `embed`, `head`."""
    out = {"layers": 0, "embed": 0, "head": 0}
    for leaf in leaves(model):
        n = math.prod(leaf.shape)
        if leaf.stacked:
            out["layers"] += n * n_layers
        elif leaf.path[0] == "embed":
            out["embed"] += n
        elif leaf.path[0] == "lm_head":
            out["head"] += n
        else:
            out["layers"] += n
    return out
