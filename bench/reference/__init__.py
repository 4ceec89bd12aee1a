"""The plain reference the benchmark holds the program against.

Plain PyTorch, computed in float32 (TF32 off) from the same bf16 weights
the program is given, a layer at a time: `rwkv6.py` (the RWKV-6 forward,
loss and gradients), `qwen2.py` (the dense GQA forward with QKV bias and
rope, ternary projections derived again by `quant.py`), `optim8.py`
(int8 error-feedback gradient compression and block-wise int8 AdamW).
The precision (`prec.py`) is `F32` for the reference, `FP8` for the
control: every product's operands rounded to float8 e4m3 on a per-tensor
scale (forward and backward), and every tensor the program holds in its
bf16 compute dtype (the residual stream, normed inputs, projections,
mixer outputs) held in float8 e4m3 likewise.  Nothing here imports the
program, JAX or the JAX package.
"""
