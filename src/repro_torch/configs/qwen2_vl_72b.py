"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution vision (stub frontend).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191; hf]
The vision tower is a stub, as in the reference: precomputed patch
embeddings are written over the first n_vision_tokens positions; M-RoPE
position ids (B, 3, S) carry the (t, h, w) streams.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    rope="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,              # qwen2 family uses QKV bias
    frontend="vision",
    n_vision_tokens=256,
    notes="full attention -> long_500k skipped (DESIGN.md §Arch-applicability)",
)
