"""Plain PyTorch versions of the population gate-level simulation.

Torch twins of `repro.kernels.circuit_sim`: a population of same-shape
genomes — `(P, G)` opcode/operand plan rows — evaluated over bit-packed
test words, vector s in bit (s % 32) of word (s // 32).  Each gate applies
its opcode through the algebraic normal form
r = m0 ^ (ma & a) ^ (mb & b) ^ (mab & a & b) with per-individual masks,
so a gate column costs the same few tensor ops whatever the opcode mix.

These run on whatever device their tensors live on.  They are the CPU
path of every wrapper in `cuda_circuit_sim` and the oracle the CUDA
kernels are held against on the card.  The host checks of a plan
(`check_plan`) and of given gate levels (`check_levels`), the plain gate
levels (`gate_levels`, numpy) and the grouping of gates by level that the
CUDA level walk runs by (`level_schedule`, tensor ops on any device) are
here too.

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


def check_plan(op, in0, in1, outputs, n_inputs: int) -> tuple:
    """Validate a `(P, G)` population plan on the host; returns int32 arrays.

    Raises `ValueError` on mismatched shapes, unknown opcodes, or a plan
    that is not feed-forward (gate g reading a node id >= n_inputs + g)
    or taps an output outside the node range.
    """
    op = np.ascontiguousarray(op, dtype=np.int32)
    in0 = np.ascontiguousarray(in0, dtype=np.int32)
    in1 = np.ascontiguousarray(in1, dtype=np.int32)
    outputs = np.ascontiguousarray(outputs, dtype=np.int32)
    if op.ndim != 2 or in0.shape != op.shape or in1.shape != op.shape:
        raise ValueError(f"op/in0/in1 must share one (P, G) shape, got "
                         f"{op.shape}, {in0.shape}, {in1.shape}")
    if outputs.ndim != 2 or outputs.shape[0] != op.shape[0]:
        raise ValueError(f"outputs must be (P, n_out), got {outputs.shape}")
    G = op.shape[1]
    ids = n_inputs + np.arange(G, dtype=np.int64)
    if ((op < 0) | (op >= N_OPS)).any():
        raise ValueError("unknown gate opcode in plan")
    if ((in0 < 0) | (in0 >= ids) | (in1 < 0) | (in1 >= ids)).any():
        raise ValueError("plan is not feed-forward")
    if ((outputs < 0) | (outputs >= n_inputs + G)).any():
        raise ValueError("output id out of range")
    return op, in0, in1, outputs


LEVEL_BLOCK = 128    # gates relaxed together by `gate_levels`


def _plan_rows(in0, in1, n_inputs: int) -> tuple[np.ndarray, np.ndarray]:
    """`(P, G)` int64 operand rows with every node id in range."""
    in0 = np.asarray(in0, dtype=np.int64)
    in1 = np.asarray(in1, dtype=np.int64)
    if in0.ndim != 2 or in1.shape != in0.shape:
        raise ValueError(f"in0/in1 must share one (P, G) shape, got "
                         f"{in0.shape}, {in1.shape}")
    n_nodes = n_inputs + in0.shape[1]
    if ((in0 < 0) | (in0 >= n_nodes) | (in1 < 0) | (in1 >= n_nodes)).any():
        raise ValueError("operand node id out of range")
    return in0, in1


def gate_levels(in0, in1, n_inputs: int) -> np.ndarray:
    """Logic levels `(P, G)` int32 of feed-forward plan rows: input nodes
    sit at level 0 and gate g at `1 + max(level(in0), level(in1))`.

    Vectorised over P.  Gates are relaxed in blocks of `LEVEL_BLOCK` in plan
    order: a block's inputs before it are final, so iterating the block's
    update to its fixed point settles it in (its internal depth + 1)
    passes.  Raises `ValueError` for a plan that is not feed-forward.
    """
    in0, in1 = _plan_rows(in0, in1, n_inputs)
    P, G = in0.shape
    ids = n_inputs + np.arange(G)
    if ((in0 >= ids) | (in1 >= ids)).any():
        raise ValueError("plan is not feed-forward")
    n_nodes = n_inputs + G
    lev = np.zeros((P, n_nodes), dtype=np.int64)
    flat = lev.reshape(-1)
    base = n_nodes * np.arange(P)[:, None]
    a_all, b_all = in0 + base, in1 + base
    for g0 in range(0, G, LEVEL_BLOCK):
        g1 = min(G, g0 + LEVEL_BLOCK)
        a, b = a_all[:, g0:g1], b_all[:, g0:g1]
        block = lev[:, n_inputs + g0:n_inputs + g1]
        while True:
            new = 1 + np.maximum(flat[a], flat[b])
            if np.array_equal(new, block):
                break
            block[...] = new
    return lev[:, n_inputs:].astype(np.int32)


def check_levels(in0, in1, outputs, n_inputs: int, levels) -> np.ndarray:
    """Validate given gate levels `(P, G)`; returns them as int64.

    Level 0 marks a gate that is not evaluated.  Every evaluated gate must
    read only input nodes and evaluated gates of a strictly lower level,
    and every output must be an input node or an evaluated gate; a level
    array that breaks this would make the level walk read values not yet
    written, so it raises `ValueError` instead.
    """
    in0, in1 = _plan_rows(in0, in1, n_inputs)
    P, G = in0.shape
    levels = np.asarray(levels, dtype=np.int64)
    if levels.shape != (P, G):
        raise ValueError(f"levels must be ({P}, {G}), got {levels.shape}")
    if (levels < 0).any():
        raise ValueError("negative gate level")
    outputs = np.asarray(outputs, dtype=np.int64).reshape(P, -1)
    if ((outputs < 0) | (outputs >= n_inputs + G)).any():
        raise ValueError("output id out of range")
    node = np.concatenate([np.zeros((P, n_inputs), np.int64), levels], 1)
    rows = np.arange(P)[:, None]

    def ready(ids, below):
        lev = node[rows, ids]
        return (ids < n_inputs) | ((lev >= 1) & (lev < below))

    sched = levels >= 1
    if (sched & ~(ready(in0, levels) & ready(in1, levels))).any():
        raise ValueError("gate levels are not a schedule: a gate reads a "
                         "node of the same or a later level")
    if not ready(outputs, np.iinfo(np.int64).max).all():
        raise ValueError("gate levels leave out a gate an output reads")
    return levels


def level_schedule(levels: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """Group `(P, G)` plan rows' gates by their levels, on `levels`' device.

    `levels` are computed (`gate_levels`) or validated (`check_levels`);
    level 0 marks a gate that is not evaluated.  Returns `(order, starts,
    depth, width)`: `order` `(P, G)` int64 lists each row's gates grouped
    by level (a stable sort, so a level-sorted row keeps its order),
    `starts` `(P, depth + 1)` int64 the offsets of the levels in it —
    level l's gates are `order[p, starts[p, l-1]:starts[p, l]]`, rows of
    smaller depth pad with empty levels, and gates past `starts[p, depth]`
    are not evaluated — `depth` the most levels of any row and `width` the
    most gates of any one level.  Node ids are not changed.
    """
    lev = levels.long()
    P, G = lev.shape
    depth = int(lev.max()) if P and G else 0
    key = torch.where(lev >= 1, lev, depth + 1)   # unevaluated gates last
    counts = torch.zeros((P, depth + 2), dtype=torch.int64,
                         device=lev.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    width = int(counts[:, 1:depth + 1].max()) if depth else 0
    order = torch.sort(key, dim=1, stable=True).indices
    starts = torch.zeros((P, depth + 1), dtype=torch.int64, device=lev.device)
    starts[:, 1:] = counts[:, 1:depth + 1].cumsum(dim=1)
    return order, starts, depth, width


def population_pc_errors(op, in0, in1, outputs, words, true: torch.Tensor,
                         n_inputs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-individual (mae, wcae) against true popcounts `(W*32,)`.

    The absolute errors are exact integers; their mean is taken in
    float64 (as `NetlistPopulation.pc_errors` does), both as float64.
    """
    approx = population_eval_uint(op, in0, in1, outputs, words, n_inputs)
    err = (approx.long() - true.long()[None, :]).abs()
    return err.double().mean(dim=1), err.max(dim=1).values.double()
