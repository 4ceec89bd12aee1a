"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf].  The reference's simplifications: meta tokens
omitted; sliding-window attention (2048) on the attention path, so decode
holds O(window + state) per sequence.
"""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    rope="std",
    rope_theta=1e4,
    swa_window=2048,
    ssm=SSMSpec(kind="mamba", state_size=16, conv_width=4, expand=2),
)
