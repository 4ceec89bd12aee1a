"""The step-level roofline of one H100 and the model's useful FLOPs.

The port of `repro.roofline.analysis`, re-derived for one Hopper device.
The reference reads a compiled XLA program's cost analysis and prices it
at a TPU's peaks; the port's step costs come from a meta trace of the
step itself (`roofline.component_costing`), and every peak comes from
`roofline.kernel_model`, the port's one source of them:

    compute_s    = sum over classes of flops / that class's peak
                   (bf16/f16 products at BF16_FLOP_PER_S, every other
                   product, float32 among them, at F32_FLOP_PER_S: the
                   port runs f32 GEMMs with TF32 off, and its attention
                   and logits in f32)
    memory_s     = bytes / HBM_BYTES_PER_S
    collective_s = 0 on one device; kept so records keep the reference's
                   schema

`Roofline` here is a step's; `kernel_model.Roofline` is one kernel's.
The reference's `parse_collectives` and `roofline_from_compiled` read
XLA's HLO, which the port does not have.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.roofline.kernel_model import (
    BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S,
)

# product classes and the peak each runs at
PEAKS = {"bf16": BF16_FLOP_PER_S, "f32": F32_FLOP_PER_S}


def flop_class(dtype) -> str:
    """The class a product of inputs in `dtype` is priced in."""
    name = str(dtype)
    return "bf16" if name in ("torch.bfloat16", "torch.float16") else "f32"


@dataclass
class Roofline:
    """A step's flops by class, bytes and (zero) collective bytes."""
    flops_by_class: dict
    bytes_accessed: float
    collective_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_class.values()))

    @property
    def compute_s(self) -> float:
        return sum(f / PEAKS[c] for c, f in self.flops_by_class.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "flops_by_class": dict(self.flops_by_class),
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_by_kind": self.coll_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference) with N = active."""
    per_tok = 6 if kind == "train" else 2
    return float(per_tok * active_params * tokens)
