"""Architecture registry of the port.

`get_config(name)` resolves an arch id to its `ModelConfig`.  The port knows
the archs whose model path it runs (`ARCHS`); the reference's other ids raise
`KeyError` until their slice lands (see ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoESpec, SSMSpec

__all__ = ["ARCHS", "ModelConfig", "MoESpec", "SSMSpec", "get_config"]

ARCHS: tuple[str, ...] = ("llama3.2-1b", "rwkv6-7b")


def get_config(name: str) -> ModelConfig:
    if name == "llama3.2-1b":
        from repro_torch.configs.llama3_2_1b import CONFIG
        return CONFIG
    if name == "rwkv6-7b":
        from repro_torch.configs.rwkv6_7b import CONFIG
        return CONFIG
    raise KeyError(f"arch {name!r} is not ported yet (the port runs "
                   f"{list(ARCHS)}); ROADMAP.md lists the slices to come")
