"""The precision a reference computes its products in."""
from __future__ import annotations

import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 on a per-tensor scale (its absmax to
    448), back in float32."""
    s = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class F32:
    """Every product in float32."""
    name = "f32"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a.float() @ b.float()

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x.float()


class FP8:
    """Every product's operands rounded to float8 e4m3 (the gradients'
    too), accumulated in float32; every other tensor in float32: the
    control, a float8 GEMM path in the program's place."""
    name = "fp8"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dim() > 2 and b.dim() == 2:
            lead = a.shape[:-1]
            return _Fp8Matmul.apply(a.float().reshape(-1, a.shape[-1]),
                                    b.float()).reshape(*lead, b.shape[-1])
        return _Fp8Matmul.apply(a.float(), b.float())

    q = staticmethod(F32.q)


class FP8Held(FP8):
    """FP8, with every tensor the program holds in bf16 (the residual
    stream, normed inputs, mixer outputs) rounded to float8 too: a
    stronger control than FP8, read for the record."""
    name = "fp8_held"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return x + (fp8_round(x) - x).detach()
        return fp8_round(x)


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
