"""The reference's archs as one H100 serves them at their published width.

Each `Family` row names an arch, the quant it serves under, the layers it
serves (None: the published depth), its prompt length, its `cache_len` and
any config overrides.  Widths are never cut: depth is cut only where the
card's 80 GB (the MoE experts in bf16: mixtral 4.83 GB a layer, arctic
26.8 GB) or a run's time (the 152k-vocab heads, qwen2-vl's layers of 2.1 B
parameters) forces it.  qwen2-vl's prompts cover its 256 stub vision
positions.  Hymba serves dense (its Mamba block is dense only); llama
serves with an fp8 KV cache.  RWKV-6 is served at full depth on its own,
so it has no row here.

`chip_smoke.py`'s `lm_families` phase serves every row;
`tools/chip_profile.py --families` profiles them; the tests serve each row
at its reduced size on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


class Family(NamedTuple):
    arch: str
    quant: str
    depth: int | None       # layers served; None for the published depth
    prompt_tokens: int
    cache_len: int
    over: tuple = ()        # config overrides as (field, value) pairs

    def config(self, **more) -> ModelConfig:
        """The published config under this row's quant and overrides (and
        `more`), cut to `depth` layers when the row gives one."""
        cfg = get_config(self.arch).replace(
            quant=self.quant, **dict(self.over), **more)
        return cfg.replace(n_layers=self.depth) if self.depth else cfg


FAMILIES = (
    Family("qwen2-1.5b", "ternary_packed", None, 32, 256),
    Family("qwen3-4b", "ternary_packed", 8, 32, 256),
    Family("qwen2.5-14b", "ternary_packed", 4, 32, 256),
    Family("mixtral-8x22b", "ternary_packed", 4, 32, 256),
    Family("arctic-480b", "ternary_packed", 1, 32, 256),
    Family("hymba-1.5b", "dense", None, 32, 256),
    Family("whisper-medium", "ternary_packed", None, 32, 256),
    Family("qwen2-vl-72b", "ternary_packed", 2, 288, 512),
    Family("llama3.2-1b", "ternary_packed", None, 32, 256,
           (("kv_cache_dtype", "float8_e4m3fn"),)),
)
