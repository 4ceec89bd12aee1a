"""Gate semantics and the `Netlist` structure check.

Copies of `repro.core.circuits._ANF_COEFF` and of the `Netlist` fields with
`validate()`.  Node ids: inputs are 0..n_inputs-1; gate g has id
n_inputs+g and may only read strictly smaller ids.  `load_program` relies
on `validate()` to refuse a bundle that is not feed-forward before any
kernel reads it: the CUDA gate walk trusts every node id it is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.hw.egfet import Gate

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
