"""qwen2-1.5b [dense] — GQA kv=2, QKV bias. 28L d_model=1536 12H d_ff=8960
vocab=151936 [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    rope="std",
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
    notes="full attention -> long_500k skipped",
)
