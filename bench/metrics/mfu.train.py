"""The window's model FLOPs over its seconds at the bf16 peak, in %:
6 N a token (N the stage's layers and the head), and three times each
layer's causal attention products (or RWKV-6's state products)."""
from bench import roofline, weights


def read(run):
    w = run.work
    if "tokens" not in w:
        return None
    model, mix = run.config["model"], run.mix
    L = w["layers"]
    n = weights.param_counts(model, L)
    H, dh = model["n_heads"], model["d_head"]
    seq = roofline.wkv_mix_flops if weights.is_rwkv(model) \
        else roofline.attention_flops
    per_seq = 3 * L * seq(mix["seq_len"], H, dh)
    flops = roofline.model_flops(n["layers"] + n["head"], w["tokens"],
                                 "train") \
        + per_seq * mix["batch"] * w["steps"]
    return 100.0 * flops / (run.window_s * roofline.BF16_FLOP_PER_S)
