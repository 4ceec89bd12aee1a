"""One driver a traffic kind: `run(ctx) -> harness.Run`.

A driver builds the program's system under test from the cell's
configuration and the run seed (set-up), runs the measured window, then
frees the program's state and holds what the window produced against the
plain reference (`bench.reference`).  The helpers here are shared.
"""
from __future__ import annotations

import dataclasses
import gc
import typing

import torch


def model_config(model: dict, n_layers: int):
    """The program's `ModelConfig` of a configuration file's `model`: each
    nested object whose field is declared as a spec class of
    `repro_torch.configs.base` (`ssm`, `moe`, ...) built as that class,
    every JSON array a tuple."""
    from repro_torch.configs import base

    def spec(hint):
        return next((t for t in (hint, *typing.get_args(hint))
                     if dataclasses.is_dataclass(t)
                     and t.__module__ == base.__name__), None)

    def value(v, hint):
        cls = spec(hint) if isinstance(v, dict) else None
        if cls is not None:
            hints = typing.get_type_hints(cls)
            return cls(**{k: value(x, hints.get(k)) for k, x in v.items()})
        if isinstance(v, list):
            return tuple(value(x, None) for x in v)
        return v

    hints = typing.get_type_hints(base.ModelConfig)
    return base.ModelConfig(**{k: value(v, hints.get(k)) for k, v in
                               dict(model, n_layers=n_layers).items()})


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def release(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def flat(tree: dict, prefix: str = "") -> dict:
    """`{"a.b.c": leaf}` of a nested dict, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for key, v in flat_tree.items():
        node = out
        *head, last = key.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
