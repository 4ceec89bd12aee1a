"""Printed-hardware definitions (gate opcodes)."""
