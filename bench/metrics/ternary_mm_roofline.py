"""The window's ternary projections' bounds over the device time of the
kernels that computed them, in %.  Each projection of each prefill group
is bounded by `roofline.ternary_roofline(M, K, N, 2)`, M the group's
rows times its prompt length and (K, N) the configuration's."""
from bench import roofline

KERNELS = ("ternary_mma_kernel", "ternary_splitk_kernel",
           "ternary_matmul_kernel")


def projections(model):
    D, F = model["d_model"], model["d_ff"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    return [(D, H * dh), (D, K * dh), (D, K * dh), (H * dh, D),
            (D, F), (D, F), (F, D)]


def read(run):
    model = run.config["model"]
    if run.trace is None or model.get("quant") != "ternary_packed":
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    bound = sum(roofline.ternary_roofline(rows * S, K, N, 2).bound_s
                for rows, S in run.work["groups"]
                for K, N in projections(model)) * model["n_layers"]
    return 100.0 * bound / seconds
