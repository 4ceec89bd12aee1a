"""Netlist structure shared by the compiler IR and the kernels."""
