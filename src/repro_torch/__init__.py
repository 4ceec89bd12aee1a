"""PyTorch/CUDA port of the `repro` serving path.

Serves compiled TNN classifiers (reference-emitted `<name>_program.npz`
bundles) end to end on an NVIDIA H100: ABC binarization, bit packing,
gate-level simulation in a hand-written CUDA kernel for `sm_90a`, and the
batching engine.  The JAX package `repro` is the reference this port is
held against bit for bit; nothing here imports it or JAX.

Every entry point takes `device=`.  Left as None it means the current CUDA
device, and raises when there is none: a CPU run is always asked for by
name (`device="cpu"`), and then runs the plain PyTorch versions.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
