"""`CircuitIR`: the levelized single-circuit gate array a bundle carries.

The dataclass of `repro.compile.ir.CircuitIR` without the lowering
functions (this package does not port the compiler yet).  Same array layout as
`Netlist` plus per-gate `levels` and named `taps` (interior node groups,
e.g. the per-class score bits).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.circuits import Netlist


@dataclass
class CircuitIR:
    """Levelized, dead-gate-eliminated single-circuit gate array."""

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
        """View as a validated `Netlist` (optionally re-rooted at tap nodes)."""
        nl = Netlist(self.n_inputs, self.op, self.in0, self.in1,
                     np.asarray(self.outputs if outputs is None else outputs,
                                dtype=np.int32),
                     name=self.name, meta=dict(self.meta))
        nl.validate()
        return nl
