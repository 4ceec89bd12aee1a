"""Analytic rooflines of the port's Hopper kernels on an H100 SXM.

The port of `repro.roofline.kernel_model`, re-derived for the card and for
the port's own kernel designs.  Each bound is the least time the card
could take for a kernel's work: the larger of the bytes it must move (each
input read once, each output written once) over HBM bandwidth and the
operations it does over the peak rate of their type.  The gate walks also
carry a chain term: a logic level cannot start before the previous
level's values are written.

Peaks (NVIDIA H100 SXM data sheet):

  * `HBM_BYTES_PER_S`   3.35e12 B/s of HBM3;
  * `INT32_OPS_PER_S`   67e12 32-bit integer ops/s on the CUDA cores (the
    gate walk's word logic, the popcount);
  * `BF16_FLOP_PER_S`   989e12 dense bf16 tensor-core FLOP/s (the ternary
    matmul, the fused prefill attention, the training head and loss);
  * `F32_FLOP_PER_S`    67e12 f32 FLOP/s on the CUDA cores (the WKV-6
    scan and its backward, `wkv_bound_ms` and `wkv_bwd_bound_ms`, and
    every float32 product of the port, which runs with TF32 off);
  * `HBM_CAPACITY_BYTES` 80 GB of HBM3 (`launch.dryrun --device cpu`
    checks a step's peak against it);
  * the chain: `CHAIN_CYCLES_PER_LEVEL` SM cycles a logic level (one
    shared-memory round trip and one barrier) at the card's highest SM
    clock, `DEFAULT_SM_CLOCK_MHZ` unless the caller reads it
    (`nvidia-smi --query-gpu=clocks.max.sm`).

Gate-walk workload: P programs x G gates x W uint32 words (32 readings a
word), `n_in` input rows, `n_out` output taps, `depth` logic levels.  A
gate is the 4-term ANF combine of two operand words, `OPS_PER_GATE_WORD`
word ops, so every design shares one operations term
`P * G * W * OPS_PER_GATE_WORD`; the designs differ in bytes:

  * `plain_roofline` — the plain PyTorch walk (`kernels/circuit_sim.py`):
    a `(P, n_in + G, W)` value plane in HBM, each gate gathering two
    operand rows and writing one, the ANF masks gathered per gate, the
    output rows gathered, then one `(P, W, 32)` int32 plane read and
    written per output bit by the decode;
  * `shared_plane_roofline` — `circuit_level_kernel` (`shared_plane`):
    the plan (`op`, `in0`, `in1` int32 a gate, `outputs`) and the word
    plane stream in once, the value plane stays in shared memory, and
    the only output is the decoded `(P, W*32)` int32 plane (or, without
    `decode`, `simulate_population`'s `(P, n_out, W)` words).  A plane
    shared by the programs is read once;
  * `global_scratch_roofline` — `circuit_walk_kernel` (`global_scratch`,
    past shared memory): as above, but each gate reads two operand rows
    from and writes one row to a scratch plane in global memory, and the
    output taps are read back from it;
  * `fleet_roofline` — the padded multi-tenant launch
    (`cuda_circuit_sim.pad_plans`): the shared-plane design over tables
    padded to `(T, G_max + 1)`, per-tenant word planes padded to
    `(T, n_in_max, W_max)`, with the padding efficiency beside it.

No TPU figure is carried over.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.rwkv6_scan import n_checkpoints

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_CAPACITY_BYTES = 80e9
DEVICE_NAME = "NVIDIA H100 SXM 80GB (data sheet)"
OPS_PER_GATE_WORD = 6          # m0 ^ (ma&a) ^ (mb&b) ^ (mab&a&b)
CHAIN_CYCLES_PER_LEVEL = 30
DEFAULT_SM_CLOCK_MHZ = 1980.0
POPCOUNT_OPS_PER_WORD = 2      # one popc and one add a word
# The factored WKV-6 recurrence's flops per (row, token, i, j): y's r*S
# and +, the update's w*S, k*v and +.
WKV_FLOPS = 5
# the WKV-6 backward's reverse walk per (row, token, i, j): the multiply-
# adds of dr, dw, dk and dv's partial sums; the recompute of the states
# from the checkpoints is counted as the forward's WKV_FLOPS beside it
WKV_BWD_FLOPS = 8
_WORD = 4                      # uint32 words, int32 plan entries and outputs
_ANF_MASK_BYTES = 4 * 4        # the plain walk's four int32 masks a gate


@dataclass(frozen=True)
class Roofline:
    """A kernel's bytes, operations and dependency chain on the card."""
    bytes_accessed: float
    ops: float
    ops_per_s: float = INT32_OPS_PER_S
    chain_s: float = 0.0

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def compute_s(self) -> float:
        return self.ops / self.ops_per_s

    @property
    def dominant(self) -> str:
        """`"bytes"` or `"operations"`: which term sets `bound_s`."""
        return "bytes" if self.memory_s >= self.compute_s else "operations"

    @property
    def bound_s(self) -> float:
        """The larger of the bytes and operations terms (the chain term is
        reported beside it, `chain_s`)."""
        return max(self.memory_s, self.compute_s)

    @property
    def bound_ms(self) -> float:
        return self.bound_s * 1e3

    @property
    def compute_ms(self) -> float:
        return self.compute_s * 1e3


def chain_bound_ms(depth: int, mhz: float = DEFAULT_SM_CLOCK_MHZ) -> float:
    """Least time for a walk of `depth` dependent logic levels at
    `CHAIN_CYCLES_PER_LEVEL` SM cycles a level and `mhz`."""
    return depth * CHAIN_CYCLES_PER_LEVEL / (mhz * 1e3)


@dataclass(frozen=True)
class CircuitShape:
    """One gate-walk launch: P programs x G gates x W words."""
    P: int
    G: int
    n_in: int
    W: int
    n_out: int
    shared_words: bool = True
    depth: int = 0

    @property
    def vectors(self) -> int:
        return self.W * 32

    @property
    def ops(self) -> float:
        return float(self.P * self.G * self.W * OPS_PER_GATE_WORD)

    def words_bytes(self) -> int:
        rows = self.n_in if self.shared_words else self.P * self.n_in
        return rows * self.W * _WORD

    def plan_bytes(self) -> int:
        """The port's plan format: `op`, `in0`, `in1` int32 a gate, plus
        the `outputs` taps."""
        return self.P * (3 * self.G + self.n_out) * _WORD

    def out_bytes(self, decode: bool) -> int:
        """The decoded `(P, W*32)` int32 plane, or the `(P, n_out, W)`
        output words."""
        per = self.vectors if decode else self.n_out * self.W
        return self.P * per * _WORD

    def chain_s(self, mhz: float) -> float:
        return chain_bound_ms(self.depth, mhz) * 1e-3


def plain_roofline(s: CircuitShape, decode: bool = True,
                   mhz: float = DEFAULT_SM_CLOCK_MHZ) -> Roofline:
    row = s.W * _WORD
    plane = s.P * (s.n_in + s.G) * row          # zero-filled value plane
    gates = s.P * s.G * (3 * row + 2 * _ANF_MASK_BYTES)
    taps = 2 * s.P * s.n_out * row              # gathered, written
    byt = s.plan_bytes() + s.words_bytes() + plane + gates + taps
    if decode:
        # one (P, W, 32) int32 plane read and written per output bit
        byt += 2 * s.n_out * s.P * s.vectors * _WORD
    return Roofline(float(byt), s.ops, chain_s=s.chain_s(mhz))


def shared_plane_roofline(s: CircuitShape, decode: bool = True,
                          mhz: float = DEFAULT_SM_CLOCK_MHZ) -> Roofline:
    byt = s.plan_bytes() + s.words_bytes() + s.out_bytes(decode)
    return Roofline(float(byt), s.ops, chain_s=s.chain_s(mhz))


def global_scratch_roofline(s: CircuitShape, decode: bool = True,
                            mhz: float = DEFAULT_SM_CLOCK_MHZ) -> Roofline:
    row = s.W * _WORD
    scratch = s.P * s.G * 3 * row + s.P * s.n_out * row
    byt = s.plan_bytes() + s.words_bytes() + scratch + s.out_bytes(decode)
    return Roofline(float(byt), s.ops, chain_s=s.chain_s(mhz))


def programs_roofline(programs: list[tuple[int, int, int, int]],
                      decode: bool = True,
                      shared_plane: bool = False) -> Roofline:
    """`shared_plane_roofline` of single-program walks `(n_in, G, n_out,
    W)` of different sizes, summed.  With `shared_plane` the programs read
    one `(n_in, W)` plane, counted once."""
    byt = ops = 0.0
    for n_in, G, n_out, W in programs:
        rl = shared_plane_roofline(
            CircuitShape(1, G, n_in, W, n_out, shared_words=False), decode)
        byt += rl.bytes_accessed
        ops += rl.ops
    if shared_plane:
        (n_in, W), = {(p[0], p[3]) for p in programs}
        byt -= (len(programs) - 1) * n_in * W * _WORD
    return Roofline(byt, ops)


def bound_ms(programs: list[tuple[int, int, int, int]], decode: bool,
             shared_plane: bool = False) -> tuple[float, str]:
    """Least time for single-program walks `(n_in, G, n_out, W)` launched
    together: `(ms, "bytes" | "operations")` of `programs_roofline`."""
    rl = programs_roofline(programs, decode, shared_plane)
    return rl.bound_ms, rl.dominant


def ops_bound_ms(programs: list[tuple[int, int, int, int]]) -> float:
    """The operations half of `bound_ms`."""
    return programs_roofline(programs).compute_ms


def fleet_roofline(shapes: list[CircuitShape],
                   mhz: float = DEFAULT_SM_CLOCK_MHZ
                   ) -> tuple[Roofline, float]:
    """The padded multi-tenant launch over per-tenant shapes (P = 1 each):
    its roofline and its padding efficiency (real gate-word work over
    padded gate-word work), the price of one launch for T plans."""
    if not shapes:
        raise ValueError("fleet_roofline needs at least one tenant shape")
    padded = CircuitShape(
        P=len(shapes), G=max(s.G for s in shapes) + 1,   # + the CONST0 gate
        n_in=max(s.n_in for s in shapes), W=max(s.W for s in shapes),
        n_out=max(s.n_out for s in shapes), shared_words=False,
        depth=max(s.depth for s in shapes))
    real = sum(s.ops for s in shapes)
    eff = real / padded.ops if padded.ops else 1.0
    return shared_plane_roofline(padded, True, mhz), eff


def roofline_row(variant: str, rl: Roofline) -> dict:
    """One harness row: the reference's keys plus the chain term."""
    return {"variant": variant, "ops": rl.ops,
            "hbm_bytes": rl.bytes_accessed,
            "arith_intensity": round(rl.ops / rl.bytes_accessed, 3),
            "dominant": rl.dominant, "bound_s": rl.bound_s,
            "chain_s": rl.chain_s}


def variant_rows(s: CircuitShape, decode: bool = True,
                 mhz: float = DEFAULT_SM_CLOCK_MHZ) -> list[dict]:
    """One row per single-launch design of the port's gate walk."""
    return [roofline_row(name, fn(s, decode, mhz)) for name, fn in (
        ("plain", plain_roofline),
        ("shared_plane", shared_plane_roofline),
        ("global_scratch", global_scratch_roofline))]


def ternary_roofline(M: int, K: int, N: int, x_bytes: int) -> Roofline:
    """`(x @ unpack(w2)) * scale`: x, the 2-bit codes w2, scale and the
    f32 output each moved once, against 2*M*K*N operations at the bf16
    tensor-core rate."""
    return Roofline(float(M * K * x_bytes + (K // 4) * N + N * 4 + M * N * 4),
                    2.0 * M * K * N, BF16_FLOP_PER_S)


def ternary_bound_ms(M: int, K: int, N: int, x_bytes: int
                     ) -> tuple[float, str]:
    """Least time for `(x @ unpack(w2)) * scale` (`ternary_roofline`)."""
    rl = ternary_roofline(M, K, N, x_bytes)
    return rl.bound_ms, rl.dominant


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int | None = None,
                    q_offset: int = 0) -> int:
    """Visible (query row, key) pairs of one head: row i (absolute position
    q_offset + i) sees keys j < Sk with j <= q_offset + i if causal and
    q_offset + i - j < window if a window is given."""
    total = 0
    for i in range(q_offset, q_offset + Sq):
        hi = min(Sk - 1, i) if causal else Sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attention_roofline(B: int, Sq: int, Sk: int, H: int, K: int, dh: int,
                       causal: bool, window: int | None = None,
                       q_offset: int = 0, x_bytes: int = 2) -> Roofline:
    """Prefill attention (`csrc/attention.cu`): q and the output (B, Sq, H,
    dh), k and v (B, Sk, K, dh) each moved once (`x_bytes` an element),
    against 4 dh flops per visible (row, key) pair a head (Q K^T and P V,
    2 dh each) at the bf16 tensor-core rate."""
    pairs = attention_pairs(Sq, Sk, causal, window, q_offset)
    n_bytes = x_bytes * B * dh * (2 * Sq * H + 2 * Sk * K)
    return Roofline(float(n_bytes), 4.0 * B * H * dh * pairs,
                    BF16_FLOP_PER_S)


def attention_bound_ms(B: int, Sq: int, Sk: int, H: int, K: int, dh: int,
                       causal: bool, window: int | None = None,
                       q_offset: int = 0, x_bytes: int = 2
                       ) -> tuple[float, str]:
    """Least time for prefill attention (`attention_roofline`)."""
    rl = attention_roofline(B, Sq, Sk, H, K, dh, causal, window, q_offset,
                            x_bytes)
    return rl.bound_ms, rl.dominant


def ce_head_roofline(M: int, K: int, V: int) -> Roofline:
    """The training head and cross-entropy, forward and backward
    (`csrc/ce_head.cu`): bf16 x (M, K) and the head (K, V) read once, the
    int32 labels read once, bf16 dX and dW written once, against 8 passes
    of 2 M K V flops at the bf16 tensor-core rate (the forward, the
    backward's recompute, dX and dW on three bf16 terms of dlogits each).
    The planes of dlogits, which the kernels write and read back, are
    the design's and not counted."""
    return Roofline(float(2 * (2 * M * K + 2 * K * V) + 4 * M),
                    8 * 2.0 * M * K * V, BF16_FLOP_PER_S)


def ce_head_bound_ms(M: int, K: int, V: int) -> tuple[float, str]:
    """Least time for the training head and loss (`ce_head_roofline`)."""
    rl = ce_head_roofline(M, K, V)
    return rl.bound_ms, rl.dominant


def wkv_roofline(BH: int, T: int, dh: int, with_s0: bool,
                 x_bytes: int = 4, u_rows: int | None = None) -> Roofline:
    """The WKV-6 scan: r, k, v (`x_bytes` an element), w, u (`u_rows`
    rows of dh, BH by default), s0 read once and y and the final state
    written once (float32), against `WKV_FLOPS` per (row, token, i, j)
    at the float32 CUDA-core rate."""
    n_bytes = (3 * x_bytes + 4 + 4) * BH * T * dh \
        + 4 * dh * (BH if u_rows is None else u_rows) \
        + 4 * BH * dh * dh * (2 if with_s0 else 1)
    return Roofline(float(n_bytes), float(WKV_FLOPS * BH * T * dh * dh),
                    F32_FLOP_PER_S)


def wkv_bound_ms(BH: int, T: int, dh: int, with_s0: bool,
                 x_bytes: int = 4, u_rows: int | None = None
                 ) -> tuple[float, str]:
    """Least time for the WKV-6 scan (`wkv_roofline`)."""
    rl = wkv_roofline(BH, T, dh, with_s0, x_bytes, u_rows)
    return rl.bound_ms, rl.dominant


def wkv_bwd_roofline(BH: int, T: int, dh: int, with_s0: bool,
                     with_ds: bool, x_bytes: int = 4,
                     u_rows: int | None = None) -> Roofline:
    """The WKV-6 backward: r, k, v (`x_bytes` an element), w and dy
    (float32), the checkpointed states a row (`rwkv6_scan.
    n_checkpoints`), u and, `with_ds`, the final state's gradient read
    once; dr, dk, dv (`x_bytes`), dw, du (`u_rows` rows of dh, BH by
    default) and, `with_s0`, ds0 written once.  Operations: the forward
    recompute (`WKV_FLOPS`) plus `WKV_BWD_FLOPS` per (row, token, i, j)
    at the float32 CUDA-core rate."""
    states = n_checkpoints(T) + int(with_ds) + int(with_s0)
    n_bytes = (3 * x_bytes + 4 + 4) * BH * T * dh \
        + (3 * x_bytes + 4) * BH * T * dh \
        + 2 * 4 * dh * (BH if u_rows is None else u_rows) \
        + 4 * BH * dh * dh * states
    flops = (WKV_FLOPS + WKV_BWD_FLOPS) * BH * T * dh * dh
    return Roofline(float(n_bytes), float(flops), F32_FLOP_PER_S)


def wkv_bwd_bound_ms(BH: int, T: int, dh: int, with_s0: bool,
                     with_ds: bool, x_bytes: int = 4,
                     u_rows: int | None = None) -> tuple[float, str]:
    """Least time for the WKV-6 backward (`wkv_bwd_roofline`)."""
    rl = wkv_bwd_roofline(BH, T, dh, with_s0, with_ds, x_bytes, u_rows)
    return rl.bound_ms, rl.dominant


def popcount_bound_ms(B: int, W: int) -> tuple[float, str]:
    """Least time for per-row popcounts of `(B, W)` words: the words read
    once and the counts written once, against `POPCOUNT_OPS_PER_WORD`."""
    rl = Roofline(float(4 * (B * W + B)), float(POPCOUNT_OPS_PER_WORD * B * W))
    return rl.bound_ms, rl.dominant
