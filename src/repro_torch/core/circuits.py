"""Gate-level netlists, their EGFET cost, builders and test vectors.

The port of `repro.core.circuits`, the substrate of the paper's three-phase
approximation flow:

  * Phase 1 (CGP, `core.cgp`) mutates netlists of this form and scores them
    against true popcounts over bit-packed test vectors — exhaustive for
    n <= 16 inputs, Hamming-weight-stratified samples above;
  * Phase 2 (`core.pcc`) composes popcount netlists and comparators into
    popcount-compare (PCC) circuits;
  * Phase 3 (`core.tnn`) plugs chosen netlists into the circuit-accurate
    TNN.

Node ids: inputs are 0..n_inputs-1; gate g (0-based) has id n_inputs+g and
may only read strictly smaller ids (a feed-forward DAG by construction).

The builders, liveness and cost are numpy on the host, copied from the
reference as they are.  Gate simulation is not: `Netlist.eval_uint` /
`simulate` and `NetlistPopulation.eval_uint` / `simulate` / `pc_errors`
take `device=` and go through `kernels.dispatch` — on a CUDA device the
hand-written gate walk (`kernels/csrc/circuit_sim.cu`), on the CPU its
plain PyTorch version (`kernels/circuit_sim.py`).  `device=None` is the
current CUDA device and raises without one.  Packed vectors stay uint64
words as in the reference (vector s in bit s % 64 of word s // 64), and
decoded values come back as int64 numpy arrays, bit-identical to the
reference's numpy simulator.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.hw.egfet import GATE_AREA_MM2, GATE_POWER_UW, Gate, HwCost

_U64 = np.uint64

# Algebraic-normal-form coefficients per opcode: f(a, b) = c0 ^ (ca & a)
# ^ (cb & b) ^ (cab & a & b).  INPUT slots behave like BUF.  The CUDA
# kernel carries the same table in `csrc/circuit_sim.cu` (`c_anf`).
_ANF_COEFF = {
    Gate.INPUT: (0, 1, 0, 0),
    Gate.CONST0: (0, 0, 0, 0),
    Gate.CONST1: (1, 0, 0, 0),
    Gate.BUF: (0, 1, 0, 0),
    Gate.NOT: (1, 1, 0, 0),
    Gate.AND: (0, 0, 0, 1),
    Gate.OR: (0, 1, 1, 1),
    Gate.XOR: (0, 1, 1, 0),
    Gate.NAND: (1, 0, 0, 1),
    Gate.NOR: (1, 1, 1, 1),
    Gate.XNOR: (1, 1, 1, 0),
    Gate.ANDN: (0, 1, 0, 1),
    Gate.ORN: (1, 0, 1, 1),
}
N_OPS = max(int(g) for g in _ANF_COEFF) + 1

GATE_AREA_VEC = np.zeros(N_OPS, dtype=np.float64)
GATE_POWER_VEC = np.zeros(N_OPS, dtype=np.float64)
for _g in Gate:
    GATE_AREA_VEC[int(_g)] = GATE_AREA_MM2[_g]
    GATE_POWER_VEC[int(_g)] = GATE_POWER_UW[_g]

# Liveness propagation rules (mirrors Netlist.active_mask's branches).
_USES_A = np.ones(N_OPS, dtype=bool)
_USES_B = np.ones(N_OPS, dtype=bool)
for _g in (Gate.INPUT, Gate.CONST0, Gate.CONST1):
    _USES_A[int(_g)] = False
for _g in (Gate.INPUT, Gate.CONST0, Gate.CONST1, Gate.NOT, Gate.BUF):
    _USES_B[int(_g)] = False


def _dispatch():
    # imported at call time: kernels.circuit_sim reads this module's ANF
    # table when it is imported
    from repro_torch.kernels import dispatch
    return dispatch


def _devices(device):
    return None if device is None else [device]


@dataclass
class Netlist:
    n_inputs: int
    op: np.ndarray        # (n_gates,) int16 Gate opcodes
    in0: np.ndarray       # (n_gates,) int32 node ids
    in1: np.ndarray       # (n_gates,) int32 node ids
    outputs: np.ndarray   # (n_outputs,) int32 node ids, LSB-first
    name: str = ""
    meta: dict = field(default_factory=dict)

    @property
    def n_gates(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.outputs.shape[0])

    def validate(self) -> None:
        """Raise `ValueError` unless the netlist is a feed-forward DAG with
        known opcodes and in-range output taps."""
        ids = np.arange(self.n_gates) + self.n_inputs
        if self.n_gates:
            if (self.in0 >= ids).any() or (self.in1 >= ids).any():
                raise ValueError("netlist is not feed-forward")
            if (self.in0 < 0).any() or (self.in1 < 0).any():
                raise ValueError("negative input id")
            if (self.op < 0).any() or (self.op >= N_OPS).any():
                raise ValueError("unknown gate opcode")
        if (self.outputs < 0).any() or (self.outputs >= self.n_inputs + self.n_gates).any():
            raise ValueError("output id out of range")

    def active_mask(self) -> np.ndarray:
        """Boolean mask over gates reachable from the outputs (live logic)."""
        live = np.zeros(self.n_inputs + self.n_gates, dtype=bool)
        live[self.outputs] = True
        # reverse sweep: DAG edges always point backwards
        for g in range(self.n_gates - 1, -1, -1):
            nid = self.n_inputs + g
            if live[nid]:
                o = self.op[g]
                if o not in (Gate.INPUT, Gate.CONST0, Gate.CONST1):
                    live[self.in0[g]] = True
                    if o not in (Gate.NOT, Gate.BUF):
                        live[self.in1[g]] = True
        return live[self.n_inputs:]

    # -- cost ---------------------------------------------------------------
    def cost(self) -> HwCost:
        act = self.active_mask()
        ops = self.op[act]
        area = float(GATE_AREA_VEC[ops].sum())
        power = float(GATE_POWER_VEC[ops].sum()) * 1e-3
        return HwCost(area, power)

    def area(self) -> float:
        return self.cost().area_mm2

    # -- simulation ---------------------------------------------------------
    def simulate(self, inputs: np.ndarray, device=None) -> np.ndarray:
        """Bit-parallel evaluation on `device`.

        inputs: uint64 (n_inputs, W) — bit k of word w of row i is test
        vector (w*64+k)'s value for input i.  Returns (n_outputs, W) uint64.
        """
        self._check_inputs(inputs)
        return self.population().simulate(inputs, device=device)[0]

    def eval_uint(self, inputs: np.ndarray, device=None) -> np.ndarray:
        """Simulate on `device` and decode outputs (LSB-first) into
        per-vector uints.

        Returns int64 array of shape (W*64,).
        """
        self._check_inputs(inputs)
        return self.population().eval_uint(inputs, device=device)[0]

    def _check_inputs(self, inputs: np.ndarray) -> None:
        if inputs.shape[0] != self.n_inputs:
            raise ValueError(f"expected {self.n_inputs} input rows, got {inputs.shape[0]}")

    def population(self) -> "NetlistPopulation":
        """This netlist as a population of one."""
        return NetlistPopulation(self.n_inputs, self.op[None], self.in0[None],
                                 self.in1[None], self.outputs[None])


# ---------------------------------------------------------------------------
# Population-parallel evaluation (structure-of-arrays over same-shape genomes)
# ---------------------------------------------------------------------------
@dataclass
class NetlistPopulation:
    """A population of P same-shape netlists as `(P, n_gates)` plan arrays.

    All individuals share `n_inputs` and `n_outputs`; gate counts are
    equalized by padding with dead CONST0 gates (`from_netlists`).  The
    whole population is simulated in one launch a device: the gate walk
    applies every individual's opcodes through their ANF coefficient masks.
    """

    n_inputs: int
    op: np.ndarray        # (P, n_gates) int16 Gate opcodes
    in0: np.ndarray       # (P, n_gates) int32 node ids
    in1: np.ndarray       # (P, n_gates) int32 node ids
    outputs: np.ndarray   # (P, n_outputs) int32 node ids, LSB-first

    @property
    def size(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_gates(self) -> int:
        return int(self.op.shape[1])

    @property
    def n_outputs(self) -> int:
        return int(self.outputs.shape[1])

    @classmethod
    def from_netlists(cls, nls: list["Netlist"]) -> "NetlistPopulation":
        """Stack netlists (same n_inputs/n_outputs) into one population.

        Heterogeneous gate counts are padded at the high-id end with CONST0
        gates, which are never reachable from the (unchanged) output ids.
        """
        if not nls:
            raise ValueError("empty population")
        n_in = nls[0].n_inputs
        n_out = nls[0].n_outputs
        for nl in nls:
            if nl.n_inputs != n_in or nl.n_outputs != n_out:
                raise ValueError("population members must share I/O shape")
        G = max(nl.n_gates for nl in nls)
        P = len(nls)
        op = np.full((P, G), int(Gate.CONST0), dtype=np.int16)
        in0 = np.zeros((P, G), dtype=np.int32)
        in1 = np.zeros((P, G), dtype=np.int32)
        outputs = np.empty((P, n_out), dtype=np.int32)
        for p, nl in enumerate(nls):
            g = nl.n_gates
            op[p, :g] = nl.op
            in0[p, :g] = nl.in0
            in1[p, :g] = nl.in1
            outputs[p] = nl.outputs
        return cls(n_in, op, in0, in1, outputs)

    def take(self, indices: np.ndarray) -> "NetlistPopulation":
        """Row-select (with repetition) a sub-population."""
        idx = np.asarray(indices)
        return NetlistPopulation(self.n_inputs, self.op[idx], self.in0[idx],
                                 self.in1[idx], self.outputs[idx])

    def netlist(self, p: int, name: str = "") -> "Netlist":
        nl = Netlist(self.n_inputs, self.op[p].astype(np.int16),
                     self.in0[p].astype(np.int32), self.in1[p].astype(np.int32),
                     self.outputs[p].astype(np.int32), name=name)
        nl.validate()
        return nl

    # -- simulation ---------------------------------------------------------
    def simulate(self, inputs: np.ndarray, device=None) -> np.ndarray:
        """Bit-parallel evaluation of the whole population on `device`.

        inputs: uint64, either shared `(n_inputs, W)` or per-individual
        `(P, n_inputs, W)`.  Returns `(P, n_outputs, W)` uint64 — row p is
        bit-identical to `self.netlist(p).simulate(...)`.
        """
        return _dispatch().population_simulate(
            self, np.ascontiguousarray(inputs, dtype=_U64), _devices(device))

    def eval_uint(self, inputs, device=None) -> np.ndarray:
        """Simulate on `device` and decode outputs (LSB-first) into
        per-vector uints, in one launch a device.

        Returns int64 `(P, W*64)` — row p matches `netlist(p).eval_uint`.
        """
        return _dispatch().population_eval_pop(self, inputs,
                                               _devices(device))

    def pc_errors(self, packed, true, device=None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Per-individual (mae, wcae) against true popcounts on `device`:
        two (P,) float64 arrays, equal to the reference's."""
        return _dispatch().population_pc_errors(self, packed, true,
                                                _devices(device))

    # -- structure / cost ---------------------------------------------------
    def active_masks(self) -> np.ndarray:
        """(P, n_gates) liveness — row p equals `netlist(p).active_mask()`."""
        P, G = self.op.shape
        n_in = self.n_inputs
        live = np.zeros((P, n_in + G), dtype=bool)
        rows = np.arange(P)
        live[rows[:, None], self.outputs] = True
        uses_a = _USES_A[self.op]
        uses_b = _USES_B[self.op]
        for g in range(G - 1, -1, -1):
            m = live[:, n_in + g]
            live[rows, self.in0[:, g]] |= m & uses_a[:, g]
            live[rows, self.in1[:, g]] |= m & uses_b[:, g]
        return live[:, n_in:]

    def areas(self) -> np.ndarray:
        """(P,) active-gate EGFET areas, bit-identical to `Netlist.cost()`."""
        act = self.active_masks()
        return np.array([GATE_AREA_VEC[self.op[p][act[p]]].sum()
                         for p in range(self.size)])


FUZZ_OPS: tuple[int, ...] = tuple(int(g) for g in Gate if g != Gate.INPUT)
# INPUT is a placeholder opcode (never emitted by builders or CGP); the
# reference's serial `Netlist.simulate` rejects it, so fuzzing excludes it.


def random_netlist_population(rng: np.random.Generator, n_inputs: int,
                              n_gates: int, n_outputs: int, size: int
                              ) -> NetlistPopulation:
    """`size` random feed-forward same-shape netlists (conformance fuzzing).

    Operand ids respect the DAG constraint (gate g reads ids < n_inputs + g);
    opcodes are drawn uniformly from the full simulate-able gate set, output
    taps uniformly over all nodes — the adversarial shape for evaluator
    conformance, covering dead gates, const-only cones, repeated taps and
    input-passthrough outputs that structured CGP genomes rarely produce.
    """
    if n_outputs > 8:
        raise ValueError("fuzz populations keep n_outputs <= 8 (u8 decode)")
    op = rng.choice(np.array(FUZZ_OPS, dtype=np.int16),
                    size=(size, n_gates)).astype(np.int16)
    hi = n_inputs + np.arange(n_gates)
    in0 = rng.integers(0, hi[None, :], size=(size, n_gates)).astype(np.int32)
    in1 = rng.integers(0, hi[None, :], size=(size, n_gates)).astype(np.int32)
    outputs = rng.integers(0, n_inputs + n_gates,
                           size=(size, n_outputs)).astype(np.int32)
    pop = NetlistPopulation(n_inputs, op, in0, in1, outputs)
    for p in range(size):
        pop.netlist(p)        # validates feed-forwardness per row
    return pop


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
class _Builder:
    """Convenience netlist builder (ids flow through python ints)."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.ops: list[int] = []
        self.i0: list[int] = []
        self.i1: list[int] = []

    def gate(self, op: int, a: int, b: int | None = None) -> int:
        self.ops.append(int(op))
        self.i0.append(int(a))
        self.i1.append(int(b if b is not None else a))
        return self.n_inputs + len(self.ops) - 1

    def const(self, v: int) -> int:
        return self.gate(Gate.CONST1 if v else Gate.CONST0, 0)

    def half_adder(self, a: int, b: int) -> tuple[int, int]:
        return self.gate(Gate.XOR, a, b), self.gate(Gate.AND, a, b)

    # -- composition hooks (used by compose_pcc and repro.compile) ----------
    def inline(self, nl: "Netlist", input_map: list[int]) -> list[int]:
        """Splice `nl`'s gates into this builder.

        `input_map[i]` is the id (in this builder) feeding `nl`'s input i;
        returns the ids of `nl`'s outputs in this builder.  Extra map entries
        are ignored, so callers can pass a shared padded map.
        """
        if len(input_map) < nl.n_inputs:
            raise ValueError(
                f"input_map has {len(input_map)} ids, netlist needs {nl.n_inputs}")
        remap = [int(i) for i in input_map[: nl.n_inputs]]
        for g in range(nl.n_gates):
            remap.append(self.gate(int(nl.op[g]), remap[nl.in0[g]],
                                   remap[nl.in1[g]]))
        return [remap[int(i)] for i in nl.outputs]

    def geq(self, a_bits: list[int], b_bits: list[int]) -> int:
        """Unsigned comparator a >= b over equal-length LSB-first bit ids."""
        if len(a_bits) != len(b_bits) or not a_bits:
            raise ValueError("geq needs equal-length non-empty bit lists")
        ge = self.gate(Gate.ORN, a_bits[0], b_bits[0])  # a0 OR NOT b0
        for k in range(1, len(a_bits)):
            gt = self.gate(Gate.ANDN, a_bits[k], b_bits[k])
            eq = self.gate(Gate.XNOR, a_bits[k], b_bits[k])
            keep = self.gate(Gate.AND, eq, ge)
            ge = self.gate(Gate.OR, gt, keep)
        return ge

    def full_adder(self, a: int, b: int, c: int) -> tuple[int, int]:
        x = self.gate(Gate.XOR, a, b)
        s = self.gate(Gate.XOR, x, c)
        g1 = self.gate(Gate.AND, a, b)
        g2 = self.gate(Gate.AND, x, c)
        cout = self.gate(Gate.OR, g1, g2)
        return s, cout

    def finish(self, outputs: list[int], name: str = "", meta: dict | None = None) -> Netlist:
        nl = Netlist(
            n_inputs=self.n_inputs,
            op=np.array(self.ops, dtype=np.int16),
            in0=np.array(self.i0, dtype=np.int32),
            in1=np.array(self.i1, dtype=np.int32),
            outputs=np.array(outputs, dtype=np.int32),
            name=name,
            meta=meta or {},
        )
        nl.validate()
        return nl


def popcount_width(n: int) -> int:
    """Output bits needed to represent popcount of n inputs (0..n)."""
    return max(1, int(np.ceil(np.log2(n + 1))))


def _reduce_counter(b: _Builder, bits: list[int]) -> list[int]:
    """Sum a list of equal-weight bits into a binary number (LSB-first ids).

    Classic carry-save counter tree: fold triples through full adders, pairs
    through half adders, recursing on the carries at the next weight.
    """
    layers: dict[int, list[int]] = {0: list(bits)}
    result: list[int] = []
    w = 0
    while any(layers.get(k) for k in layers if k >= w):
        cur = layers.setdefault(w, [])
        while len(cur) >= 3:
            s, co = b.full_adder(cur.pop(), cur.pop(), cur.pop())
            cur.append(s)
            layers.setdefault(w + 1, []).append(co)
        if len(cur) == 2:
            s, co = b.half_adder(cur.pop(), cur.pop())
            cur.append(s)
            layers.setdefault(w + 1, []).append(co)
        result.append(cur[0] if cur else b.const(0))
        w += 1
        if w > 64:
            raise RuntimeError("counter runaway")
    return result


def popcount_netlist(n: int) -> Netlist:
    """Exact n-input popcount as a carry-save adder tree."""
    b = _Builder(n)
    outs = _reduce_counter(b, list(range(n)))
    m = popcount_width(n)
    while len(outs) < m:
        outs.append(b.const(0))
    return b.finish(outs[:m], name=f"pc{n}_exact", meta={"n": n, "exact": True})


def truncated_popcount_netlist(n: int, drop: int) -> Netlist:
    """Truncation baseline (Fig. 4): ignore the last `drop` inputs and add
    a constant compensation of drop/2 (round-to-nearest expected value)."""
    b = _Builder(n)
    outs = _reduce_counter(b, list(range(n - drop)))
    m = popcount_width(n)
    comp = drop // 2
    # add constant comp via wiring const-1s into the counter would be wasteful;
    # instead add comp as extra const bits (synthesizable: they fold away).
    if comp:
        cbits = []
        for k in range(m):
            if (comp >> k) & 1:
                cbits.append((k, b.const(1)))
        # ripple-add the constant
        res = list(outs) + [b.const(0)] * (m - len(outs))
        carry = None
        for k in range(m):
            addend = None
            for kk, cid in cbits:
                if kk == k:
                    addend = cid
            terms = [t for t in (res[k] if k < len(res) else None, addend, carry) if t is not None]
            if len(terms) == 3:
                s, carry = b.full_adder(*terms)
            elif len(terms) == 2:
                s, carry = b.half_adder(*terms)
            else:
                s, carry = (terms[0] if terms else b.const(0)), None
            if k < len(res):
                res[k] = s
            else:
                res.append(s)
        outs = res
    m = popcount_width(n)
    while len(outs) < m:
        outs.append(b.const(0))
    return b.finish(outs[:m], name=f"pc{n}_trunc{drop}", meta={"n": n, "drop": drop})


def comparator_geq_netlist(j: int) -> Netlist:
    """j-bit unsigned comparator: out = (a >= b).

    Inputs: a_0..a_{j-1} (ids 0..j-1, LSB first), b_0..b_{j-1} (ids j..2j-1).
    """
    b = _Builder(2 * j)
    ge = b.geq(list(range(j)), list(range(j, 2 * j)))
    return b.finish([ge], name=f"cmp_geq{j}", meta={"j": j})


def compose_pcc(pc_pos: Netlist, pc_neg: Netlist, n_pos: int, n_neg: int) -> Netlist:
    """Popcount-compare circuit: out = (pc_pos(x_pos) >= pc_neg(x_neg)).

    Inputs: first n_pos bits then n_neg bits.  The two PC netlists are
    inlined, zero-extended to a common width j, followed by the comparator.
    """
    j = max(popcount_width(n_pos), popcount_width(n_neg))
    b = _Builder(n_pos + n_neg)
    pos_out = b.inline(pc_pos, list(range(n_pos)))
    neg_out = b.inline(pc_neg, list(range(n_pos, n_pos + n_neg)))
    zero = None

    def pad(bits: list[int]) -> list[int]:
        nonlocal zero
        while len(bits) < j:
            if zero is None:
                zero = b.const(0)
            bits.append(zero)
        return bits[:j]

    a_bits = pad(pos_out)
    b_bits = pad(neg_out)
    ge = b.geq(a_bits, b_bits)
    nl = b.finish(
        [ge],
        name=f"pcc_{n_pos}x{n_neg}[{pc_pos.name},{pc_neg.name}]",
        meta={"n_pos": n_pos, "n_neg": n_neg, "pos": pc_pos.name, "neg": pc_neg.name},
    )
    return nl


# ---------------------------------------------------------------------------
# Test-vector generation (the BDD stand-in)
# ---------------------------------------------------------------------------
def pack_vectors(vectors: np.ndarray) -> np.ndarray:
    """Pack boolean test vectors (..., S, n) into uint64 words (..., n, ceil(S/64)).

    Vector s lands in bit (s % 64) of word (s // 64).  Leading batch axes
    (e.g. one vector set per population member) pass through unchanged.
    """
    *lead, S, n = vectors.shape
    W = (S + 63) // 64
    padded = np.zeros((*lead, W * 64, n), dtype=np.uint8)
    padded[..., :S, :] = vectors.astype(np.uint8)
    # bit k of word w <- vector w*64+k  => within each 64 block, LSB-first
    blocks = padded.reshape(*lead, W, 64, n)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[:, None]
    words = (blocks.astype(np.uint64) * weights).sum(axis=-2, dtype=np.uint64)
    return np.ascontiguousarray(np.swapaxes(words, -1, -2))


def exhaustive_vectors(n: int) -> np.ndarray:
    """All 2^n input vectors, packed: (n, 2^n/64) uint64."""
    if n > 22:
        raise ValueError("exhaustive sweep limited to n<=22")
    S = 1 << n
    idx = np.arange(S, dtype=np.uint64)
    vecs = ((idx[:, None] >> np.arange(n, dtype=np.uint64)[None, :]) & np.uint64(1)).astype(np.uint8)
    return pack_vectors(vecs)


def stratified_vectors(n: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """Hamming-weight-stratified random vectors for n > exhaustive limit.

    Popcount-circuit error depends on input weight, so uniform-bit sampling
    under-covers extreme weights; stratify ~uniformly over weights 0..n plus
    a uniform-bit tail (mirrors the paper's 1e6-random-pair methodology).
    """
    rng = np.random.default_rng(seed)
    per_w = max(1, n_samples // (2 * (n + 1)))
    rows = []
    for w in range(n + 1):
        m = np.zeros((per_w, n), dtype=np.uint8)
        for r in range(per_w):
            m[r, rng.choice(n, size=w, replace=False)] = 1
        rows.append(m)
    n_tail = max(0, n_samples - per_w * (n + 1))
    if n_tail:
        rows.append((rng.random((n_tail, n)) < 0.5).astype(np.uint8))
    vecs = np.concatenate(rows, axis=0)
    return pack_vectors(vecs)


def eval_vectors(n: int, exhaustive_limit: int = 16, n_samples: int = 1 << 17,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(packed_inputs, true_popcounts) for error evaluation of an n-bit PC."""
    if n <= exhaustive_limit:
        packed = exhaustive_vectors(n)
        S = 1 << n
        idx = np.arange(S, dtype=np.uint64)
        true = np.zeros(S, dtype=np.int64)
        for k in range(n):
            true += ((idx >> np.uint64(k)) & np.uint64(1)).astype(np.int64)
        # pad up to word multiple with vector 0 replicas (weight 0)
        W = packed.shape[1]
        if W * 64 > S:
            true = np.concatenate([true, np.zeros(W * 64 - S, dtype=np.int64)])
        return packed, true
    packed = stratified_vectors(n, n_samples, seed)
    true = popcount_of_packed(packed)
    return packed, true


def popcount_of_packed(packed: np.ndarray) -> np.ndarray:
    """True per-vector popcount from packed inputs (n, W) -> (W*64,)."""
    n, W = packed.shape
    bits = np.unpackbits(np.ascontiguousarray(packed).view(np.uint8)
                         .reshape(n, W * 8), axis=-1, bitorder="little")
    return bits.sum(axis=0).astype(np.int64)


def pc_error(nl: Netlist, packed: np.ndarray, true: np.ndarray,
             device=None) -> tuple[float, float]:
    """(mean_abs_error, worst_case_abs_error) of a popcount netlist."""
    approx = nl.eval_uint(packed, device=device)
    err = np.abs(approx - true)
    return float(err.mean()), float(err.max())
