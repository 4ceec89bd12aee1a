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

One module an architecture.  A configuration file names its module by
its optional top-level key `reference`; without it the module is
`rwkv6` where the model's `ssm.kind` is `rwkv6`, else `qwen2`.  A new
architecture joins the benchmark as a new module here, a configuration
file and a cell: nothing else under `bench/` names a module.  A module
gives, `model` being the configuration file's `model`:

  * `leaves(model)`: the weight layout, a list of `weights.Leaf` in a
    fixed order (`weights.base_leaves` begins every layout here); a leaf
    may name the layers it exists in;
  * `consts(model, S, device)`: what its layer needs for S tokens (rope
    tables), or None;
  * `layer(model, lp, x, consts, prec, index)`: layer `index` (absolute)
    on the float32 stream x (B, S, D), `lp` the leaves that layer has;
  * `logits(model, final_scale, head_w, x, prec)`;
  * `loss(model, params, tokens, labels, prec)`, where it can be
    trained: (sum of label NLL, label count) through every layer of a
    layer-stacked tree;
  * `seq_flops(model, S, n_layers)`: the model FLOPs of one S-token
    sequence through layers 0 .. n_layers - 1, forward: 2 for each
    parameter a token passes (an MoE's routed experts k of E), and each
    layer's mixer products under its own mask, from `bench/roofline.py`;
  * `ternary_shapes(model, index)`: the `(K, N)` of each projection layer
    `index` sends through the ternary kernel.
"""
from __future__ import annotations

import importlib


def name(config: dict) -> str:
    """The reference module's name of a configuration file."""
    from bench.weights import is_rwkv
    return config.get("reference") or (
        "rwkv6" if is_rwkv(config["model"]) else "qwen2")


def module(config: dict):
    """The reference module of a configuration file."""
    return importlib.import_module(f"{__name__}.{name(config)}")
