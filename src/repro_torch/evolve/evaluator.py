"""Campaign-facing fitness evaluation API.

The port of `repro.evolve.evaluator`.  The dispatch of the gate walk over
devices lives below the orchestration layer in `repro_torch.kernels.dispatch`,
so core problems (`core.tnn.TNNApproxProblem`) reach it without importing
upward into this package; this module re-exports it under the name
campaigns and benchmarks use.  There are no backend names: the device
decides (`devices=None` is the current CUDA device).
"""
from repro_torch.kernels.dispatch import (  # noqa: F401
    population_eval_pop,
    population_eval_uint,
    population_pc_errors,
)
