"""The frozen yardstick: peaks, kernel rooflines and model FLOPs.

A copy of the port's `roofline/kernel_model.py` arithmetic (ternary
matmul, WKV-6 forward and backward) and of `roofline/analysis.py`'s
`model_flops`, with an attention term added, kept here so that a change
to the program cannot move the yardstick.  Each bound counts the work of
the computation, not of the kernel that implements it: every operand read
once, every result written once, against the operations at the peak rate
of their type (NVIDIA H100 SXM data sheet, dense rates, 700 W).
"""
from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# the WKV-6 recurrence's flops per (row, token, i, j): y's r*S and +, the
# update's w*S, k*v and +
WKV_FLOPS = 5
# the backward's reverse walk per (row, token, i, j), beside the forward
# recompute from the checkpoints (counted as WKV_FLOPS)
WKV_BWD_FLOPS = 8
# tokens between the states a WKV-6 gradient run keeps
WKV_CKPT_TOKENS = 16


@dataclass(frozen=True)
class Roofline:
    bytes_accessed: float
    ops: float
    ops_per_s: float

    @property
    def bound_s(self) -> float:
        return max(self.bytes_accessed / HBM_BYTES_PER_S,
                   self.ops / self.ops_per_s)


def ternary_roofline(M: int, K: int, N: int, x_bytes: int) -> Roofline:
    """`(x @ unpack(w2)) * scale`: x, the 2-bit codes, the scale and the
    f32 output moved once; 2*M*K*N operations at the bf16 rate."""
    return Roofline(float(M * K * x_bytes + (K // 4) * N + N * 4 + M * N * 4),
                    2.0 * M * K * N, BF16_FLOP_PER_S)


def wkv_roofline(BH: int, T: int, dh: int, with_s0: bool,
                 x_bytes: int = 4, u_rows: int | None = None) -> Roofline:
    """The WKV-6 scan: r, k, v (`x_bytes` each), w and y (f32) a (row,
    token, i); u (`u_rows` rows); s0 read and the final state written
    (f32); `WKV_FLOPS` per (row, token, i, j) at the f32 rate."""
    n_bytes = (3 * x_bytes + 4 + 4) * BH * T * dh \
        + 4 * dh * (BH if u_rows is None else u_rows) \
        + 4 * BH * dh * dh * (2 if with_s0 else 1)
    return Roofline(float(n_bytes), float(WKV_FLOPS * BH * T * dh * dh),
                    F32_FLOP_PER_S)


def wkv_checkpoints(T: int) -> int:
    return -(-T // WKV_CKPT_TOKENS)


def wkv_bwd_roofline(BH: int, T: int, dh: int, with_s0: bool,
                     with_ds: bool, x_bytes: int = 4,
                     u_rows: int | None = None) -> Roofline:
    """The WKV-6 backward: r, k, v, w, dy and the checkpointed states
    read, dr, dk, dv, dw, du (and ds0) written once; the recompute plus
    `WKV_BWD_FLOPS` per (row, token, i, j) at the f32 rate."""
    states = wkv_checkpoints(T) + int(with_ds) + int(with_s0)
    n_bytes = (3 * x_bytes + 4 + 4) * BH * T * dh \
        + (3 * x_bytes + 4) * BH * T * dh \
        + 2 * 4 * dh * (BH if u_rows is None else u_rows) \
        + 4 * BH * dh * dh * states
    flops = (WKV_FLOPS + WKV_BWD_FLOPS) * BH * T * dh * dh
    return Roofline(float(n_bytes), float(flops), F32_FLOP_PER_S)


def model_flops(params: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference (N the parameters a token
    passes through)."""
    return float((6 if kind == "train" else 2) * params * tokens)


def attention_pairs(S: int, window: int | None = None) -> int:
    """The (query, key) pairs causal attention over S tokens sees: each
    query the keys at or before it, with a window the `window` latest of
    them (key k seen by query q where q - window < k <= q)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(S: int, n_heads: int, d_head: int,
                    window: int | None = None) -> float:
    """The causal score and value products of one attention layer over
    an S-token sequence, forward: 2 * 2 * H * dh flops for each of the
    S (S + 1) / 2 (query, key) pairs, or each of `attention_pairs`'
    under a window."""
    if window is None:
        return 2.0 * n_heads * d_head * S * (S + 1)
    return 4.0 * n_heads * d_head * attention_pairs(S, window)


def wkv_mix_flops(S: int, n_heads: int, d_head: int) -> float:
    """RWKV-6's time-mixing state products of one layer over S tokens,
    forward, counted as matrix products: r.S and the k^T v update, 2 * 2
    * H * dh^2 a token."""
    return 4.0 * n_heads * d_head * d_head * S
