"""The window's model FLOPs over its seconds at the bf16 peak, in %:
2 N a token through the layers (prompt and fed-back tokens), 2 N of the
head at each served position only, and each layer's causal attention
products (or RWKV-6's state products) over the sequence."""
from bench import roofline, weights


def read(run):
    reqs = run.work.get("requests")
    if not reqs:
        return None
    model = run.config["model"]
    L = model["n_layers"]
    n = weights.param_counts(model, L)
    H, dh = model["n_heads"], model["d_head"]
    mix = roofline.wkv_mix_flops if weights.is_rwkv(model) \
        else roofline.attention_flops
    flops = 0.0
    for plen, got, _, _ in reqs:
        S = plen + max(got, 1) - 1
        flops += roofline.model_flops(n["layers"], S, "serve") \
            + roofline.model_flops(n["head"], got, "serve") \
            + L * mix(S, H, dh)
    return 100.0 * flops / (run.window_s * roofline.BF16_FLOP_PER_S)
