"""rwkv6-7b [ssm] — "Finch", attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892].  64 heads of
size 64 in the WKV mixer; the recurrent state replaces the KV cache, so
decode holds O(1) state per sequence.
"""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # wkv heads (d_model / rwkv_head_size)
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    rope="none",
    ssm=SSMSpec(kind="rwkv6", rwkv_head_size=64, lora_rank=64),
)
