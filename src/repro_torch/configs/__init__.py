"""Architecture registry of the port.

`get_config(name)` resolves an arch id to its `ModelConfig`, the port's own
copy of the reference's config file; `ARCHS` lists the ten ids in the
reference's order, `PORT_ONLY` the archs the reference does not have
(`mellum2-12b-a2.5b`), which `get_config` resolves too.  An unknown id
raises `KeyError`.  `SHAPES` and
`shape_applicable` are the dry-run cells (`configs.base`).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES, ModelConfig, MoESpec, RopeSpec, ShapeConfig, SSMSpec,
    shape_applicable,
)

__all__ = ["ARCHS", "PORT_ONLY", "SHAPES", "ModelConfig", "MoESpec",
           "RopeSpec", "SSMSpec", "ShapeConfig", "get_config",
           "shape_applicable"]

ARCHS: tuple[str, ...] = (
    "qwen2-vl-72b",
    "hymba-1.5b",
    "whisper-medium",
    "arctic-480b",
    "mixtral-8x22b",
    "llama3.2-1b",
    "qwen2-1.5b",
    "qwen3-4b",
    "qwen2.5-14b",
    "rwkv6-7b",
)

PORT_ONLY: tuple[str, ...] = ("mellum2-12b-a2.5b",)

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_")
            .replace(".", "_") for name in ARCHS + PORT_ONLY}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
