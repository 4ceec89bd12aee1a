"""Executable side of the circuit compiler: IR, programs and bundles."""
