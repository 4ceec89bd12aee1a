"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; anything else as given.

    There is no silent CPU fallback: with no CUDA device, `None` or a
    `cuda` device raise `RuntimeError`, and the CPU runs only when the
    caller names it.  A bare `"cuda"` is pinned to the current device
    index so that device comparisons downstream are exact.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' to run the plain PyTorch "
                "versions instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
