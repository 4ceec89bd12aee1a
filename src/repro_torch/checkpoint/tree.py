"""Leaf order and leaf paths of a nested state, as the reference records them.

A checkpoint's manifest lists its leaves in the order JAX's
`tree_util.tree_flatten` visits them, each under the path `keystr` prints
for it; the port writes and reads the same lists with no JAX:

  * a dict's children in sorted key order, each under `[<repr(key)>]`
    (`['islands']`, `[3]`);
  * a list's or a tuple's in order, each under `[<index>]`;
  * `None` is a subtree with no leaves;
  * anything else (a numpy array, a tensor, a Python or numpy scalar) is
    one leaf.
"""
from __future__ import annotations

from typing import Any


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """`[(path step, child)]` of an interior node, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """`[(keystr path, leaf)]` in JAX's flatten order."""
    out: list[tuple[str, Any]] = []

    def walk(node: Any, path: str) -> None:
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for step, child in kids:
            walk(child, path + step)

    walk(tree, "")
    return out


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def leaf_paths(tree: Any) -> list[str]:
    return [path for path, _ in flatten_with_paths(tree)]


def unflatten(template: Any, new_leaves: list[Any]) -> Any:
    """`template`'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
