"""The window's model FLOPs over its seconds at the bf16 peak, in %: three
times each sequence's forward through the stage's layers, as the
configuration's reference module counts it (`seq_flops`), and 6 N of the
head a token."""
from bench import reference, roofline, weights


def read(run):
    w = run.work
    if "tokens" not in w:
        return None
    model, mix = run.config["model"], run.mix
    L = w["layers"]
    arch = reference.module(run.config)
    head = weights.param_counts(run.config, L)["head"]
    flops = 3 * arch.seq_flops(model, mix["seq_len"], L) \
        * mix["batch"] * w["steps"] \
        + roofline.model_flops(head, w["tokens"], "train")
    return 100.0 * flops / (run.window_s * roofline.BF16_FLOP_PER_S)
