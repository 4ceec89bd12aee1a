"""Analytic rooflines of the port's kernels on the H100 (`kernel_model`)."""
