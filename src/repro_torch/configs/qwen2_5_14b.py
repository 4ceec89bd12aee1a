"""qwen2.5-14b [dense] — GQA kv=8, QKV bias. 48L d_model=5120 40H d_ff=13824
vocab=152064 [hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    rope="std",
    rope_theta=1e6,
    qkv_bias=True,
    notes="full attention -> long_500k skipped",
)
