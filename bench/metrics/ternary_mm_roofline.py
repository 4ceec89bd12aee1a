"""The window's ternary projections' bounds over the device time of the
kernels that computed them, in %.  Each projection of each prefill group
is bounded by `roofline.ternary_roofline(M, K, N, 2)`, M the group's
rows times its prompt length and (K, N) each that the configuration's
reference module says the layer sends through the kernel
(`ternary_shapes`)."""
from collections import Counter

from bench import reference, roofline

KERNELS = ("ternary_mma_kernel", "ternary_splitk_kernel",
           "ternary_matmul_kernel")


def read(run):
    model = run.config["model"]
    if run.trace is None or model.get("quant") != "ternary_packed":
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    arch = reference.module(run.config)
    # layers alike are bounded once and counted as many times
    alike = Counter(tuple(arch.ternary_shapes(model, i))
                    for i in range(model["n_layers"]))
    bound = 0.0
    for shapes, n in alike.items():
        bound += sum(roofline.ternary_roofline(rows * S, K, N, 2).bound_s
                     for rows, S in run.work["groups"]
                     for K, N in shapes) * n
    return 100.0 * bound / seconds if bound else None
