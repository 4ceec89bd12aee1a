"""The weights every cell runs, drawn by the benchmark from `--seed`.

Both sides get the same values: the program as its parameter tree (the
port's layout: layer-stacked leaves with a leading L axis, projections as
`{"w": (K, N)}`), the reference a layer at a time, drawn again.  Each
architecture's layout, its list of `Leaf`, is its reference module's
`leaves(model)` (`bench/reference/`); a leaf may exist in some layers
only, and is stacked over those.  Each (leaf, layer) has a generator of
its own, seeded from (run seed, leaf path, absolute layer), so any layer
is drawn alone without the others; the draws run on the device in one
call per (leaf, layer), in float32, scaled, and are stored in the leaf's
dtype.

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
    layers: tuple | None = None   # the absolute layers it exists in; None: all


def is_rwkv(model: dict) -> bool:
    return (model.get("ssm") or {}).get("kind") == "rwkv6"


def proj(path, K, N, dt, bias=False, residual_depth=0) -> list[Leaf]:
    """A `(K, N)` projection's leaves, `w` N(0, 1/K) (scaled down by
    sqrt(2 residual_depth) where it writes into the residual stream) and
    its bias N(0, 0.1)."""
    std = 1 / math.sqrt(K)
    if residual_depth:
        std /= math.sqrt(2 * residual_depth)
    out = [Leaf(path + ("w",), (K, N), dt, ("normal", std), True)]
    if bias:
        out.append(Leaf(path + ("b",), (N,), dt, ("normal", 0.1), True))
    return out


def base_leaves(model: dict) -> list[Leaf]:
    """The leaves every architecture here begins with: the embedding, the
    final norm, the untied head, and each layer's two pre-norms."""
    D, V = model["d_model"], model["vocab"]
    dt = DTYPES[model["param_dtype"]]
    out = [Leaf(("embed", "tokens"), (V, D), dt, ("normal", 0.02), False),
           Leaf(("final_norm", "scale"), (D,), dt, ("one_plus", 0.1), False)]
    if model.get("tie_embeddings"):
        raise ValueError("tied embeddings are not drawn by this benchmark")
    out.append(Leaf(("lm_head", "w"), (D, V), dt,
                    ("normal", 1 / math.sqrt(D)), False))
    for n in ("ln1", "ln2"):
        out.append(Leaf(("layers", n, "scale"), (D,), dt, ("one_plus", 0.1),
                        True))
    return out


def leaves(config: dict) -> list[Leaf]:
    """Every leaf of the dense tree of a configuration file, in a fixed
    order: its reference module's `leaves` of the file's `model`."""
    from bench import reference
    return reference.module(config).leaves(config["model"])


def present(leaf: Leaf, n_layers: int) -> list[int]:
    """The layers of 0 .. n_layers - 1 a stacked leaf exists in."""
    return [i for i in range(n_layers)
            if leaf.layers is None or i in leaf.layers]


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


def draw(config: dict, seed: int, device, n_layers: int) -> dict:
    """The dense parameter tree of `n_layers` layers (layers 0 ..
    n_layers - 1) on `device`: a stacked leaf over the layers it exists
    in, in order."""
    tree: dict = {}
    for leaf in leaves(config):
        if leaf.stacked:
            idx = present(leaf, n_layers)
            if not idx:
                continue
            t = torch.empty((len(idx), *leaf.shape), dtype=leaf.dtype,
                            device=device)
            for j, i in enumerate(idx):
                draw_leaf(leaf, seed, device, i, out=t[j])
        else:
            t = draw_leaf(leaf, seed, device)
        _put(tree, leaf.path, t)
    return tree


def draw_layer(config: dict, seed: int, device, layer: int) -> dict:
    """Layer `layer`'s leaves, the `layers` subtree without its L axis:
    those the layer has."""
    tree: dict = {}
    for leaf in leaves(config):
        if leaf.stacked and (leaf.layers is None or layer in leaf.layers):
            _put(tree, leaf.path[1:], draw_leaf(leaf, seed, device, layer))
    return tree


def draw_top(config: dict, seed: int, device, name: str) -> torch.Tensor:
    """A leaf outside the layers by its dotted path (`embed.tokens`,
    `final_norm.scale`, `lm_head.w`)."""
    path = tuple(name.split("."))
    leaf, = [lf for lf in leaves(config) if lf.path == path]
    return draw_leaf(leaf, seed, device)


def counts(layout: list[Leaf], n_layers: int) -> dict:
    """Parameters of a tree of leaves `layout` by part: `layers` (those
    of layers 0 .. n_layers - 1 that each leaf exists in), `embed`,
    `head`."""
    out = {"layers": 0, "embed": 0, "head": 0}
    for leaf in layout:
        n = math.prod(leaf.shape)
        if leaf.stacked:
            out["layers"] += n * len(present(leaf, n_layers))
        elif leaf.path[0] == "embed":
            out["embed"] += n
        elif leaf.path[0] == "lm_head":
            out["head"] += n
        else:
            out["layers"] += n
    return out


def param_counts(config: dict, n_layers: int) -> dict:
    """`counts` of a configuration file's tree."""
    return counts(leaves(config), n_layers)
