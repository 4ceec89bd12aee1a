"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088].
SWA window 4096 -> the rolling KV cache is O(window).
"""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    rope="std",
    rope_theta=1e6,
    swa_window=4096,
    moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
)
