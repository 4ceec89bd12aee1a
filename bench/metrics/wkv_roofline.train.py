"""The window's WKV-6 forward and backward bounds, each once a layer a
microbatch a step (remat's second forward is how the program implements
the work, not work), over the device time of every WKV kernel, in %."""
from bench import roofline, weights

KERNELS = ("rwkv6_scan_kernel", "rwkv6_scan_bwd_kernel")


def read(run):
    model, mix, w = run.config["model"], run.mix, run.work
    if run.trace is None or not weights.is_rwkv(model) or "steps" not in w:
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    H, dh = model["n_heads"], model["d_head"]
    BH = mix["batch"] // mix["microbatches"] * H
    T = mix["seq_len"]
    one = roofline.wkv_roofline(BH, T, dh, False, 2, H).bound_s \
        + roofline.wkv_bwd_roofline(BH, T, dh, False, False, 2, H).bound_s
    bound = one * w["layers"] * mix["microbatches"] * w["steps"]
    return 100.0 * bound / seconds
