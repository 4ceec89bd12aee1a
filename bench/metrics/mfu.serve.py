"""The window's model FLOPs over its seconds at the bf16 peak, in %: each
request's sequence (prompt and fed-back tokens) through the layers, as
the configuration's reference module counts it (`seq_flops`: 2 for each
parameter a token passes, and each layer's mixer products under its own
mask), and 2 N of the head at each served position only."""
from bench import reference, roofline, weights


def read(run):
    reqs = run.work.get("requests")
    if not reqs:
        return None
    model = run.config["model"]
    L = model["n_layers"]
    arch = reference.module(run.config)
    head = weights.param_counts(run.config, L)["head"]
    flops = 0.0
    for plen, got, _, _ in reqs:
        S = plen + max(got, 1) - 1
        flops += arch.seq_flops(model, S, L) \
            + roofline.model_flops(head, got, "serve")
    return 100.0 * flops / (run.window_s * roofline.BF16_FLOP_PER_S)
