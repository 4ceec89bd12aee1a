"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base].  Dense-MoE hybrid: every layer runs a
dense FFN residual branch in parallel with the 128e top-2 MoE.  The
sharding and 8-bit optimizer fields are the reference's, kept for equality.
"""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab=32000,
    rope="std",
    rope_theta=1e6,
    moe=MoESpec(n_experts=128, top_k=2, capacity_factor=1.25,
                dense_residual=True, d_ff_dense=4864),
    opt_8bit=True,
    notes="full attention -> long_500k skipped",
)
