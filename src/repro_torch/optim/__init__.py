from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply_updates,
    global_norm,
    init,
    schedule,
    state_from_arrays,
)
