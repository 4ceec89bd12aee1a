"""Per-row popcount of bit-packed words: the plain PyTorch version and the
router.

`packed_popcount(words)` takes `(B, W)` int32 words, each the bit pattern
of one uint32 word of the reference (the port's convention:
`circuit_sim.py`), and returns the `(B,)` int32 number of set bits in each
row — the paper's popcount unit over a batch.  The tensor's device picks
the executor: on the CPU the plain version below, on a CUDA device the
hand-written kernel (`cuda_packed_popcount`, `csrc/packed_popcount.cu`);
nothing falls back from one to the other.  Unlike the Pallas kernel
`repro/kernels/packed_popcount.py`, which needs `B % 256 == 0`, both take
any `B` and `W`.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def packed_popcount_plain(words: torch.Tensor) -> torch.Tensor:
    """The reference's SWAR bit count (`ref.packed_popcount_ref`) per
    word, summed over each row.  It runs on the words widened to int64
    and masked to their 32 bits, so every shift is logical and the
    multiply cannot overflow."""
    v = words.long() & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _U32) >> 24
    return v.sum(dim=-1).int()


def check_operands(words: torch.Tensor) -> tuple[int, int]:
    """Dtype, shape and contiguity checks; returns `(B, W)`."""
    if not isinstance(words, torch.Tensor):
        raise TypeError("words must be a torch.Tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 bit patterns, got "
                        f"{words.dtype}")
    if words.dim() != 2:
        raise ValueError(f"words must be (B, W), got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    return words.shape[0], words.shape[1]


def packed_popcount(words: torch.Tensor) -> torch.Tensor:
    """`(B, W)` int32 words -> `(B,)` int32 popcounts, by device."""
    check_operands(words)
    if words.device.type == "cpu":
        return packed_popcount_plain(words)
    if words.device.type == "cuda":
        from repro_torch.kernels import cuda_packed_popcount
        return cuda_packed_popcount.launch(words)
    raise ValueError(f"no executor for device {words.device}")
