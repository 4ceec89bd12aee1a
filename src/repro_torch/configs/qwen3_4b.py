"""qwen3-4b [dense] — qk_norm, GQA kv=8. 36L d_model=2560 32H d_ff=9728
vocab=151936 [hf:Qwen/Qwen3-8B family].  Note qwen3 uses a decoupled
head_dim=128 (n_heads*d_head != d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    rope="std",
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    notes="full attention -> long_500k skipped",
)
