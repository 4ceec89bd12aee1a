"""Gate opcodes and the EGFET printed-technology cost model.

A copy of `repro.hw.egfet`.  The `Gate` values are the on-disk opcodes of
every program bundle and the CGP genome, so they must never drift from the
reference.  The cost model is an analytical per-gate area (mm^2) and
static power (uW) table for the EGFET PDK at 0.6 V / 5 Hz, fitted to the
paper's anchors (4-bit flash ADC 12 mm^2 / 1.0 mW, the ABC 0.07 mm^2 /
0.03 mW, BreastCancer's exact TNN 29 mm^2 / 0.31 mW); it preserves the
ratios between exact and approximate designs that the evaluation is about.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


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


# mm^2 per gate.  (INPUT/CONST are free: they are wires / rails.)
GATE_AREA_MM2: dict[int, float] = {
    Gate.INPUT: 0.0,
    Gate.CONST0: 0.0,
    Gate.CONST1: 0.0,
    Gate.BUF: 0.0,          # a wire in a bespoke (hardwired) design
    Gate.NOT: 0.045,
    Gate.AND: 0.11,
    Gate.OR: 0.11,
    Gate.XOR: 0.22,
    Gate.NAND: 0.08,
    Gate.NOR: 0.08,
    Gate.XNOR: 0.22,
    Gate.ANDN: 0.13,
    Gate.ORN: 0.13,
}

# uW per gate (static-dominated at 0.6 V / 5 Hz).
GATE_POWER_UW: dict[int, float] = {
    Gate.INPUT: 0.0,
    Gate.CONST0: 0.0,
    Gate.CONST1: 0.0,
    Gate.BUF: 0.0,
    Gate.NOT: 0.40,
    Gate.AND: 1.00,
    Gate.OR: 1.00,
    Gate.XOR: 1.90,
    Gate.NAND: 0.70,
    Gate.NOR: 0.70,
    Gate.XNOR: 1.90,
    Gate.ANDN: 1.15,
    Gate.ORN: 1.15,
}

# ---------------------------------------------------------------------------
# Sensor interface costs (Sec. 3.1 / Table 3 "w/ ADC cost" columns).
# ---------------------------------------------------------------------------
ADC4_AREA_MM2 = 12.0     # 4-bit flash ADC, per input feature
ADC4_POWER_MW = 1.0
ABC_AREA_MM2 = 0.07      # proposed analog-to-binary converter, per feature
ABC_POWER_MW = 0.03
SENSOR_POWER_MW = 0.005  # ~5 uW per sensor

# v/f operating point (kept for documentation & power-budget checks)
VDD_V = 0.6
FREQ_HZ = 5.0

# Printed power sources (Sec. 5): can the design be powered?
HARVESTER_BUDGET_MW = 2.0     # printed energy harvester [4]
ZINERGY_BATTERY_MW = 15.0
MOLEX_BATTERY_MW = 30.0


@dataclass(frozen=True)
class HwCost:
    """Area (mm^2) / power (mW) aggregate for a circuit or system."""

    area_mm2: float
    power_mw: float

    def __add__(self, other: "HwCost") -> "HwCost":
        return HwCost(self.area_mm2 + other.area_mm2, self.power_mw + other.power_mw)

    def scale(self, k: float) -> "HwCost":
        return HwCost(self.area_mm2 * k, self.power_mw * k)

    @property
    def area_cm2(self) -> float:
        return self.area_mm2 / 100.0


def gate_cost(op: int) -> HwCost:
    return HwCost(GATE_AREA_MM2[op], GATE_POWER_UW[op] * 1e-3)


def interface_cost(n_features: int, kind: str) -> HwCost:
    """Sensor-processor interface cost for `n_features` analog inputs."""
    if kind == "adc4":
        return HwCost(ADC4_AREA_MM2 * n_features, ADC4_POWER_MW * n_features)
    if kind == "abc":
        return HwCost(ABC_AREA_MM2 * n_features, ABC_POWER_MW * n_features)
    raise ValueError(f"unknown interface kind: {kind!r}")


def power_source(total_power_mw: float) -> str:
    """Which printed power source can drive the design (Sec. 5 discussion)."""
    if total_power_mw <= HARVESTER_BUDGET_MW:
        return "energy-harvester"
    if total_power_mw <= ZINERGY_BATTERY_MW:
        return "zinergy-battery"
    if total_power_mw <= MOLEX_BATTERY_MW:
        return "molex-battery"
    return "exceeds-printed-budget"
