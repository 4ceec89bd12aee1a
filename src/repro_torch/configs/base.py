"""Model and shape configuration, the port's copy of `repro.configs.base`.

Field names and defaults are the reference's, so a config built here and
one built there describe the same model; `reduced()` derives the same small
same-family config the CPU tests use.  Sharding-only fields
(`serve_fsdp`, `replicate_kv`, `moe_fsdp`, ...) are kept for that equality
even though the single-device port reads none of them.  `SHAPES` are the
four dry-run cells (`launch.dryrun`, `launch.roofline_run`) and
`shape_applicable` says which of them an arch can run, with the
reference's reason when it cannot.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    d_ff_dense: int | None = None     # width of the parallel dense FFN


@dataclass(frozen=True)
class SSMSpec:
    kind: str                         # "mamba" | "rwkv6"
    state_size: int = 16              # mamba N
    conv_width: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    dt_rank: int = 0                  # 0 -> d_inner (simplified)
    rwkv_head_size: int = 64
    lora_rank: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None         # default d_model // n_heads
    rope: str = "std"                 # std | mrope | none
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: int | None = None
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    enc_layers: int = 0               # whisper encoder depth
    enc_seq: int = 1500               # whisper audio frames (stub frontend)
    frontend: str | None = None       # "audio" | "vision" (stub embeddings)
    n_vision_tokens: int = 256        # vlm stub patch embeddings per sample
    act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: str = "dense"              # dense | ternary | ternary_packed
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    opt_8bit: bool = False            # int8 AdamW moments
    accum_dtype: str = "float32"      # gradient-accumulation buffer dtype
    moe_fsdp: str = "d"               # expert-weight extra shard dim: d|f|none
    attn_block_k: int = 1024          # blockwise-attention KV block size
    serve_fsdp: bool = True           # sharded serving layout (reference only)
    kv_cache_dtype: str = "compute"   # "compute" | "float8_e4m3fn"
    replicate_kv: bool = False        # sharded k/v layout (reference only)
    serve_sharded_logits: bool = False  # vocab-sharded logits (reference only)
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.ssm is not None and self.ssm.kind == "rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / windowed attention)."""
        return self.attention_free or self.family == "hybrid" or self.swa_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the reference's)."""
        half = 16 // 2   # reduced d_head = 16
        sec = (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)
        kw: dict = dict(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16, d_ff=128, vocab=128,
            mrope_sections=sec,
            enc_layers=2 if self.enc_layers else 0, enc_seq=12,
            n_vision_tokens=4 if self.frontend == "vision" else self.n_vision_tokens,
            param_dtype="float32", compute_dtype="float32",
            remat=False, opt_8bit=False,
            swa_window=8 if self.swa_window else None,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2,
                d_ff_dense=64 if self.moe.d_ff_dense else None)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_size=4, rwkv_head_size=16, lora_rank=4)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-not).  long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token KV decode has no "
                       "sub-quadratic path (DESIGN.md §Arch-applicability)")
    return True, ""
