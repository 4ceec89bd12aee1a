"""Gate opcodes of the netlist, CGP genome and bundle format.

A copy of `repro.hw.egfet.Gate`: the values are the on-disk opcodes of
every program bundle, so they must never drift from the reference.  The
EGFET cost model stays in the reference until the compiler is ported.
"""
from __future__ import annotations

import enum


class Gate(enum.IntEnum):
    """Gate/function opcodes shared by the netlist + CGP genome."""

    INPUT = 0
    CONST0 = 1
    CONST1 = 2
    BUF = 3     # wire / identity(a)
    NOT = 4
    AND = 5
    OR = 6
    XOR = 7
    NAND = 8
    NOR = 9
    XNOR = 10
    ANDN = 11   # a AND (NOT b)
    ORN = 12    # a OR  (NOT b)
