"""Plain PyTorch versions of the population gate-level simulation.

Torch twins of `repro.kernels.circuit_sim`: a population of same-shape
genomes — `(P, G)` opcode/operand plan rows — evaluated over bit-packed
test words, vector s in bit (s % 32) of word (s // 32).  Each gate applies
its opcode through the algebraic normal form
r = m0 ^ (ma & a) ^ (mb & b) ^ (mab & a & b) with per-individual masks,
so a gate column costs the same few tensor ops whatever the opcode mix.

These run on whatever device their tensors live on.  They are the CPU
path of every wrapper in `cuda_circuit_sim` and the oracle the CUDA
kernels are held against on the card.

Words are carried as int32 *bit patterns* (the uint32 word reinterpreted):
torch's uint32 lacks shifts on the CPU, and int32 `>>` is arithmetic, so
every right shift is followed by `& 1`.  Word planes are `(n_inputs, W)`
shared by the population or `(P, n_inputs, W)` per individual.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.circuits import _ANF_COEFF, N_OPS


def _anf_masks() -> torch.Tensor:
    """`(4, N_OPS)` int32 rows m0, ma, mb, mab: 0 or -1 (all 32 bits set)."""
    masks = torch.zeros((4, N_OPS), dtype=torch.int32)
    for g, coeff in _ANF_COEFF.items():
        masks[:, int(g)] = -torch.tensor(coeff, dtype=torch.int32)
    return masks


ANF_MASKS = _anf_masks()


def pack_words32(packed_u64: np.ndarray) -> np.ndarray:
    """Reinterpret `(..., n, W)` uint64 packed vectors as `(..., n, 2W)` uint32.

    Little-endian lane split: uint64 word w's low half becomes word 2w, so
    vector s sits in bit (s % 32) of word (s // 32).
    """
    packed_u64 = np.ascontiguousarray(packed_u64, dtype=np.uint64)
    *lead, n, W = packed_u64.shape
    lo = (packed_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (packed_u64 >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1).reshape(*lead, n, 2 * W)


def words_tensor(words32, device) -> torch.Tensor:
    """uint32 words (numpy) or int32 bit patterns (tensor) -> contiguous
    int32 tensor on `device`."""
    if isinstance(words32, torch.Tensor):
        if words32.dtype != torch.int32:
            raise TypeError(f"word tensors are int32 bit patterns, got "
                            f"{words32.dtype}")
        return words32.to(device).contiguous()
    words32 = np.ascontiguousarray(words32, dtype=np.uint32)
    return torch.from_numpy(words32.view(np.int32)).to(device)


def pack_bits32(bits: torch.Tensor) -> torch.Tensor:
    """Pack a `(S, n)` 0/1 tensor into `(n, ceil(S/32))` int32 words.

    Runs on `bits`' device.  The 32 weighted bits of a word are summed in
    int64 and the sum (< 2**32) is wrapped to the int32 bit pattern, so a
    reading at s % 32 == 31 lands in the sign bit.
    """
    S, n = bits.shape
    W = (S + 31) // 32
    padded = torch.zeros((W * 32, n), dtype=torch.int64, device=bits.device)
    padded[:S] = bits.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = (padded.view(W, 32, n) * weights[None, :, None]).sum(dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).T.contiguous()


def simulate_population(op: torch.Tensor, in0: torch.Tensor,
                        in1: torch.Tensor, outputs: torch.Tensor,
                        words: torch.Tensor, n_inputs: int) -> torch.Tensor:
    """op/in0/in1: (P, G) int; outputs: (P, n_out) int; words: (n_inputs, W)
    or (P, n_inputs, W) int32.  Returns (P, n_out, W) int32 output words."""
    dev = words.device
    P, G = op.shape
    W = words.shape[-1]
    m0, ma, mb, mab = ANF_MASKS.to(dev)[:, op.long()]          # (P, G) each
    vals = torch.zeros((P, n_inputs + G, W), dtype=torch.int32, device=dev)
    vals[:, :n_inputs] = words
    rows = torch.arange(P, device=dev)
    in0_t, in1_t = in0.long().T, in1.long().T                   # (G, P)
    for g in range(G):
        a = vals[rows, in0_t[g]]                                # (P, W)
        b = vals[rows, in1_t[g]]
        vals[:, n_inputs + g] = (m0[:, g, None] ^ (ma[:, g, None] & a)
                                 ^ (mb[:, g, None] & b)
                                 ^ (mab[:, g, None] & (a & b)))
    return vals[rows[:, None], outputs.long()]


def decode_words(outw: torch.Tensor) -> torch.Tensor:
    """(P, n_out, W) int32 output words -> (P, W*32) int32, LSB-first:
    value[p, 32w+s] = sum_o bit_s(outw[p, o, w]) << o."""
    P, n_out, W = outw.shape
    shifts = torch.arange(32, dtype=torch.int32, device=outw.device)
    acc = torch.zeros((P, W, 32), dtype=torch.int32, device=outw.device)
    for o in range(n_out):
        acc |= ((outw[:, o, :, None] >> shifts) & 1) << o
    return acc.reshape(P, W * 32)


def population_eval_uint(op, in0, in1, outputs, words, n_inputs: int
                         ) -> torch.Tensor:
    """Decoded per-vector outputs (LSB-first): (P, W*32) int32."""
    return decode_words(
        simulate_population(op, in0, in1, outputs, words, n_inputs))


def population_pc_errors(op, in0, in1, outputs, words, true: torch.Tensor,
                         n_inputs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-individual (mae, wcae) against true popcounts `(W*32,)`.

    The absolute errors are exact integers; their mean is taken in
    float64 (as `NetlistPopulation.pc_errors` does), both as float64.
    """
    approx = population_eval_uint(op, in0, in1, outputs, words, n_inputs)
    err = (approx.long() - true.long()[None, :]).abs()
    return err.double().mean(dim=1), err.max(dim=1).values.double()
