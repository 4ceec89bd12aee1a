"""mellum2-12b-a2.5b [moe] — window and full attention layers, 64 experts
top-8, dropless [hf:JetBrains/Mellum2-12B-A2.5B-Instruct config.json].

28L d_model=2304 32H (GQA kv=4, head 128) vocab=98304, untied head,
rms_norm_eps 1e-6, no attention bias.  `layer_types`: three
`sliding_attention` layers (window 1024, default rope at theta 5e5), then
one `full_attention` layer (YaRN: theta 5e5, factor 16 of 8192 original
positions, beta_fast 32, beta_slow 1, attention factor 1.27726), repeated.
Every layer sparse: 64 experts of width 896, top 8, weights renormalized,
no shared expert; routed dropless (every assignment computed), so under
`ternary_packed` the experts too are 2-bit codes.
The config's MTP head is left out: serving does not use it.  A port-only
arch: the reference has no such model.

`reduced()` keeps one whole period (layers w, w, w, full), window 8, 4
experts top 2, dh 16; YaRN keeps its 8192 original positions, whose
correction dims at dh 16 are 2.26 -> 2 and 4.37 -> 5, inside the 8
frequencies, so the ramp's both ends show.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, RopeSpec

THETA = 500000.0

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    n_layers=28,
    d_model=2304,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=896,
    vocab=98304,
    rope="std",
    rope_theta=THETA,
    norm_eps=1e-6,
    swa_window=1024,
    layer_types=(("sliding_attention",) * 3 + ("full_attention",)) * 7,
    rope_full=RopeSpec("yarn", THETA, factor=16.0,
                       original_max_position_embeddings=8192,
                       beta_fast=32.0, beta_slow=1.0,
                       attention_factor=1.2772588722239782),
    rope_sliding=RopeSpec("default", THETA),
    moe=MoESpec(n_experts=64, top_k=8, dropless=True),
)
