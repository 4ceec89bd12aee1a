"""The paper's benchmark harness on the PyTorch/CUDA port.

One module per table or figure, each the counterpart of the module of the
same name in `benchmarks/` (the JAX reference's harness), driven by
`python -m benchmarks_torch.run [--only ...] [--device cuda|cpu]`.  It
imports only `repro_torch`: neither JAX, nor `repro`, nor `benchmarks`.
"""
