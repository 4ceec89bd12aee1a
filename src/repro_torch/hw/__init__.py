"""Printed-hardware definitions: gate opcodes and the EGFET cost model."""
