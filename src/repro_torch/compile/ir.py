"""Circuit compiler IR — lowering evolved classifiers to deployable gates.

The port of `repro.compile.ir`, NumPy on the host as the reference is, with
its dtypes (`op` int16, node ids and `levels` int32), so a bundle written
from a port-lowered classifier has the reference's bytes.

After Phase 3 an evolved design exists as scattered `Netlist` objects (one
approximate PCC per hidden neuron, one approximate popcount per output
neuron) plus the TNN's ternary wiring.  `lower_classifier` flattens the
whole decision function

    ABC bits -> per-neuron PCCs -> XNOR/popcount scores -> argmax

into ONE `CircuitIR`: a dead-gate-eliminated, levelized gate array whose
outputs are the binary class index.  The same IR drives both backends:

  * `repro_torch.compile.program.CircuitProgram` — batched bit-packed
    execution on the device (the gate walk of `kernels/csrc/circuit_sim.cu`
    on the card), and
  * `repro_torch.compile.verilog` — synthesizable structural RTL + EGFET
    report.

Levelization sorts gates by logic depth (stable within a level), which (a)
keeps the array a valid feed-forward schedule, (b) makes emitted RTL read
level-by-level, and (c) exposes the critical-path depth for the 5 Hz EGFET
timing sanity check.  The argmax is lowered to real gates
(`argmax_netlist`) so the compiled circuit — unlike the analytic
`tnn.argmax_cost` estimate — *is* the full classifier, with np.argmax
first-max tie semantics preserved bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import circuits as C
from repro_torch.core.circuits import Netlist, _Builder
from repro_torch.hw.egfet import Gate, HwCost


@dataclass
class CircuitIR:
    """Levelized, dead-gate-eliminated single-circuit gate array.

    Same array layout as `Netlist` plus per-gate `levels` and named `taps`
    (interior node groups — e.g. hidden-neuron bits — kept live through DCE
    so backends can observe them).  Every gate is reachable from a root by
    construction, so `cost()` needs no liveness pass.
    """

    n_inputs: int
    op: np.ndarray        # (n_gates,) int16 Gate opcodes, level-sorted
    in0: np.ndarray       # (n_gates,) int32 node ids
    in1: np.ndarray       # (n_gates,) int32 node ids
    outputs: np.ndarray   # (n_outputs,) int32 node ids, LSB-first
    levels: np.ndarray    # (n_gates,) int32 logic depth (inputs are level 0)
    taps: dict[str, np.ndarray] = field(default_factory=dict)
    name: str = ""
    meta: dict = field(default_factory=dict)

    @property
    def n_gates(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.outputs.shape[0])

    @property
    def depth(self) -> int:
        return int(self.levels.max()) if self.n_gates else 0

    def to_netlist(self, outputs: np.ndarray | None = None) -> Netlist:
        """View as a `Netlist` (optionally re-rooted at tap nodes)."""
        nl = Netlist(self.n_inputs, self.op, self.in0, self.in1,
                     np.asarray(self.outputs if outputs is None else outputs,
                                dtype=np.int32),
                     name=self.name, meta=dict(self.meta))
        nl.validate()
        return nl

    def cost(self) -> HwCost:
        """EGFET cost of the lowered logic (all gates are live)."""
        area = float(C.GATE_AREA_VEC[self.op].sum())
        power = float(C.GATE_POWER_VEC[self.op].sum()) * 1e-3
        return HwCost(area, power)

    def gate_histogram(self) -> dict[str, int]:
        names, counts = np.unique(self.op, return_counts=True)
        return {Gate(int(o)).name: int(c) for o, c in zip(names, counts)
                if int(c)}

    def stats(self) -> dict:
        cost = self.cost()
        return {
            "n_inputs": self.n_inputs,
            "n_gates": self.n_gates,
            "n_outputs": self.n_outputs,
            "depth": self.depth,
            "area_mm2": round(cost.area_mm2, 4),
            "power_mw": round(cost.power_mw, 5),
            "gates": self.gate_histogram(),
        }


def _live_nodes(n_inputs: int, op: np.ndarray, in0: np.ndarray,
                in1: np.ndarray, roots: np.ndarray) -> np.ndarray:
    """Boolean liveness over all nodes, seeded at `roots` (node ids)."""
    G = int(op.shape[0])
    live = np.zeros(n_inputs + G, dtype=bool)
    live[roots] = True
    uses_a = C._USES_A[op]
    uses_b = C._USES_B[op]
    for g in range(G - 1, -1, -1):
        if live[n_inputs + g]:
            if uses_a[g]:
                live[in0[g]] = True
            if uses_b[g]:
                live[in1[g]] = True
    return live


def lower(n_inputs: int, op: np.ndarray, in0: np.ndarray, in1: np.ndarray,
          outputs: np.ndarray, taps: dict[str, np.ndarray] | None = None,
          name: str = "", meta: dict | None = None) -> CircuitIR:
    """Dead-gate eliminate + levelize raw gate arrays into a `CircuitIR`.

    Roots are `outputs` plus every tap node.  Unused operand slots (NOT/BUF
    `in1`, CONST operands) are normalized to input 0 so they never pin dead
    gates live or survive as dangling references after compaction.
    """
    op = np.asarray(op, dtype=np.int16)
    in0 = np.ascontiguousarray(in0, dtype=np.int32).copy()
    in1 = np.ascontiguousarray(in1, dtype=np.int32).copy()
    outputs = np.asarray(outputs, dtype=np.int32)
    taps = {k: np.asarray(v, dtype=np.int32) for k, v in (taps or {}).items()}
    in0[~C._USES_A[op]] = 0
    in1[~C._USES_B[op]] = 0

    roots = np.concatenate([outputs.ravel()]
                           + [t.ravel() for t in taps.values()]).astype(np.int64)
    live = _live_nodes(n_inputs, op, in0, in1, roots)
    keep = np.where(live[n_inputs:])[0]

    # logic depth over live gates (inputs and consts anchor at 0 / 1)
    lvl = np.zeros(n_inputs + op.shape[0], dtype=np.int32)
    uses_a = C._USES_A[op]
    uses_b = C._USES_B[op]
    for g in keep:
        la = lvl[in0[g]] if uses_a[g] else 0
        lb = lvl[in1[g]] if uses_b[g] else 0
        lvl[n_inputs + g] = max(la, lb) + 1

    order = keep[np.argsort(lvl[n_inputs + keep], kind="stable")]
    new_id = np.full(n_inputs + op.shape[0], -1, dtype=np.int64)
    new_id[:n_inputs] = np.arange(n_inputs)
    new_id[n_inputs + order] = n_inputs + np.arange(order.shape[0])

    ir = CircuitIR(
        n_inputs=n_inputs,
        op=op[order],
        in0=new_id[in0[order]].astype(np.int32),
        in1=new_id[in1[order]].astype(np.int32),
        outputs=new_id[outputs].astype(np.int32).reshape(outputs.shape),
        levels=lvl[n_inputs + order],
        taps={k: new_id[v].astype(np.int32).reshape(v.shape)
              for k, v in taps.items()},
        name=name,
        meta=meta or {},
    )
    ir.to_netlist()  # validates feed-forwardness of the compacted arrays
    return ir


def lower_netlist(nl: Netlist, taps: dict[str, np.ndarray] | None = None
                  ) -> CircuitIR:
    """Lower a single `Netlist` (keeps its outputs as the only roots)."""
    return lower(nl.n_inputs, nl.op, nl.in0, nl.in1, nl.outputs, taps=taps,
                 name=nl.name, meta=dict(nl.meta))


class _ConstPool:
    """Memoized CONST0/CONST1 nodes for one builder (one gate per value)."""

    def __init__(self, b: _Builder):
        self.b = b
        self.ids: dict[int, int] = {}

    def __call__(self, v: int) -> int:
        if v not in self.ids:
            self.ids[v] = self.b.const(v)
        return self.ids[v]


def argmax_netlist(n_classes: int, score_bits: int) -> Netlist:
    """First-max argmax over `n_classes` unsigned scores, as pure gates.

    Inputs are class-major LSB-first score bits (input o*score_bits + k is
    bit k of class o); outputs are the winning class index (LSB-first,
    ceil(log2(C)) bits).  Fold semantics: the running best is replaced only
    on strictly-greater score, which reproduces `np.argmax`'s first-max tie
    behaviour exactly.
    """
    if n_classes < 1 or score_bits < 1:
        raise ValueError("argmax needs n_classes >= 1 and score_bits >= 1")
    idx_bits = max(1, int(np.ceil(np.log2(n_classes)))) if n_classes > 1 else 1
    b = _Builder(n_classes * score_bits)
    const = _ConstPool(b)

    def score(o: int) -> list[int]:
        return [o * score_bits + k for k in range(score_bits)]

    best_s = score(0)
    best_i = [const(0)] * idx_bits
    for o in range(1, n_classes):
        cand = score(o)
        ge = b.geq(best_s, cand)            # best >= cand
        take = b.gate(Gate.NOT, ge)         # cand strictly greater -> replace
        best_s = [b.gate(Gate.OR, b.gate(Gate.AND, take, c),
                         b.gate(Gate.ANDN, s, take))
                  for c, s in zip(cand, best_s)]
        obits = [const((o >> k) & 1) for k in range(idx_bits)]
        best_i = [b.gate(Gate.OR, b.gate(Gate.AND, take, c),
                         b.gate(Gate.ANDN, s, take))
                  for c, s in zip(obits, best_i)]
    return b.finish(best_i, name=f"argmax_{n_classes}x{score_bits}",
                    meta={"n_classes": n_classes, "score_bits": score_bits})


@dataclass
class CompiledClassifier:
    """A fully lowered classifier: one IR + the structure it came from.

    `ir` outputs are the class-index bits; taps `hidden` (H,) and `score`
    (C, score_bits) expose the interior planes.  The source netlists and
    ternary output wiring are retained for the Verilog backend, which emits
    module-per-PCC structural RTL instead of one flat gate soup.
    """

    ir: CircuitIR
    thresholds: np.ndarray          # (F,) ABC V_q per feature
    n_features: int
    n_classes: int
    score_bits: int
    hidden_nls: list[Netlist]
    out_nls: list[Netlist]
    w1t: np.ndarray                 # (F, H) int8 ternary input wiring
    w2t: np.ndarray                 # (H, C) int8 ternary output wiring
    name: str = ""

    @property
    def index_bits(self) -> int:
        return self.ir.n_outputs


def hidden_input_map(w1_col: np.ndarray, n_inputs: int) -> list[int]:
    """Feature ids feeding one hidden PCC: [w=+1 features..., w=-1 features...].

    Degenerate PCCs (constant-1 netlists for all-zero / no-negative columns)
    carry dummy input ports; those are padded with feature 0, matching the
    `predict_with_circuits` convention of never reading them.
    """
    fmap = list(np.where(w1_col == 1)[0]) + list(np.where(w1_col == -1)[0])
    while len(fmap) < n_inputs:
        fmap.append(0)
    return fmap


def lower_classifier(tnn, hidden_nls: list[Netlist], out_nls: list[Netlist],
                     name: str | None = None) -> CompiledClassifier:
    """Flatten a (possibly approximate) evolved TNN into one `CircuitIR`.

    `tnn` is a `repro_torch.core.tnn.TrainedTNN`; `hidden_nls`/`out_nls` come from
    `exact_netlists` or an NSGA-II chromosome via `TNNApproxProblem.decode`.
    The lowered circuit is bit-identical to `predict_with_circuits` (pinned
    by tests/test_torch_compile.py across all Table-2 datasets).
    """
    F, H = tnn.w1t.shape
    Cc = tnn.w2t.shape[1]
    if len(hidden_nls) != H or len(out_nls) != Cc:
        raise ValueError("need one hidden netlist per neuron and one output "
                         "netlist per class")
    b = _Builder(F)

    # hidden plane: inline each PCC over its +/- feature slices
    h_nodes = [b.inline(nl, hidden_input_map(tnn.w1t[:, i], nl.n_inputs))[0]
               for i, nl in enumerate(hidden_nls)]

    const = _ConstPool(b)

    # output plane: XNOR simplification (wire for w=+1, NOT for w=-1) into
    # the per-class popcount netlist; zero-extend scores to a common width
    j = max((nl.n_outputs for nl in out_nls), default=1)
    score_nodes = np.empty((Cc, j), dtype=np.int64)
    for o in range(Cc):
        col = tnn.w2t[:, o]
        bmap = [h_nodes[i] for i in np.where(col == 1)[0]]
        bmap += [b.gate(Gate.NOT, h_nodes[i]) for i in np.where(col == -1)[0]]
        if not bmap:
            bits = [const(0)] * j
        else:
            bits = b.inline(out_nls[o], bmap)
            bits += [const(0)] * (j - len(bits))
        score_nodes[o] = bits[:j]

    # argmax plane (first-max fold, real gates)
    am = argmax_netlist(Cc, j)
    class_bits = b.inline(am, list(score_nodes.reshape(-1)))

    ir = lower(
        F, np.array(b.ops, dtype=np.int16), np.array(b.i0, dtype=np.int32),
        np.array(b.i1, dtype=np.int32), np.array(class_bits, dtype=np.int32),
        taps={"hidden": np.array(h_nodes, dtype=np.int32),
              "score": score_nodes.astype(np.int32)},
        name=name or f"tnn_classifier_{tnn.name or 'anon'}",
        meta={"n_classes": Cc, "score_bits": j, "n_hidden": H,
              "dataset": tnn.name},
    )
    return CompiledClassifier(
        ir=ir, thresholds=np.asarray(tnn.thresholds, dtype=np.float64),
        n_features=F, n_classes=Cc, score_bits=j,
        hidden_nls=list(hidden_nls), out_nls=list(out_nls),
        w1t=tnn.w1t.copy(), w2t=tnn.w2t.copy(),
        name=ir.name)
