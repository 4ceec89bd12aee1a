"""The window's expert products' bounds over the device time of the
grouped ternary expert kernel that computed them, in %.  Each layer of
each prefill group of T tokens (its rows times its prompt length) routes
T k assignments over E experts; the bound is E times
`roofline.ternary_roofline(T k / E, K, N, 2)` for each expert matrix,
(d_model, d_ff) twice (gate, up) and (d_ff, d_model) (down): the same
work whatever implements it."""
from bench import roofline

KERNELS = ("expert_mma_kernel",)


def read(run):
    model = run.config["model"]
    moe = model.get("moe") or {}
    if run.trace is None or model.get("quant") != "ternary_packed" \
            or not moe.get("dropless"):
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    E, k = moe["n_experts"], moe["top_k"]
    D, F = model["d_model"], model["d_ff"]
    bound = 0.0
    for rows, S in run.work["groups"]:
        M = rows * S * k / E
        bound += E * (2 * roofline.ternary_roofline(M, D, F, 2).bound_s
                      + roofline.ternary_roofline(M, F, D, 2).bound_s)
    return 100.0 * bound * model["n_layers"] / seconds
