"""The window's WKV-6 forward bounds (each layer of each prefill group,
`roofline.wkv_roofline` with bf16 r, k, v and one shared bonus) over the
device time of the WKV forward kernels, in %."""
from bench import roofline, weights

KERNELS = ("rwkv6_scan_kernel",)


def read(run):
    model = run.config["model"]
    if run.trace is None or not weights.is_rwkv(model):
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    H, dh = model["n_heads"], model["d_head"]
    bound = sum(roofline.wkv_roofline(rows * H, S, dh, False, 2, H).bound_s
                for rows, S in run.work["groups"]) * model["n_layers"]
    return 100.0 * bound / seconds
