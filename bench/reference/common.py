"""What the reference modules share: the RMS norm, the head's logits and
a layer's leaves of a layer-stacked tree."""
from __future__ import annotations

import torch

from bench.reference.prec import F32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def logits(model: dict, final_scale, head_w, x: torch.Tensor,
           prec=F32) -> torch.Tensor:
    return prec.mm(rms_norm(x, final_scale, model["norm_eps"]), head_w)


def layer_params(tree: dict, i: int) -> dict:
    """Layer i of a layer-stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
