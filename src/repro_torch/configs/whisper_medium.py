"""whisper-medium [audio] — encoder-decoder, conv frontend stubbed.

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865 [arXiv:2212.04356].
24 encoder + 24 decoder layers; the conv1d/log-mel frontend is a stub, as
in the reference: the batch carries frame embeddings (B, 1500, d_model).
LayerNorm + GELU per the original architecture; learned positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder depth
    enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    rope="none",          # learned positional embeddings
    act="gelu",
    norm="layernorm",
    frontend="audio",
    notes="full attention -> long_500k skipped",
)
