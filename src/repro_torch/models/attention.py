"""Attention: blockwise online softmax (prefill) and cached decode.

The port of `repro.models.attention`, in the reference's arithmetic (f32
scores, `NEG_INF` masking, running max and sum over `block_k` KV blocks) so
that the tests compare like with like; no library attention operator is
used.  GQA is native: queries are grouped per KV head and K/V are never
repeated to H heads.  `blockwise_attention` sends bf16 calls on the card
that autograd does not record to the hand-written fused kernel
(`kernels/cuda_attention.py`, routed by its `plan`: the same function at
f32 precision, only the visible key tiles, scores kept on chip); every
other call runs the blockwise code below.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_attention as CA

NEG_INF = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, block_k: int = 1024
                        ) -> torch.Tensor:
    """Online-softmax attention with grouped queries.

    q: (B, Sq, H, h); k, v: (B, Sk, K, h) with H % K == 0.  q_offset is the
    absolute position of q[0] relative to k[0].  Returns (B, Sq, H, h).
    Calls `cuda_attention.plan` routes to `fused` run the kernel, whose
    result does not depend on `block_k`; the rest run
    `blockwise_attention_plain`.
    """
    p = CA.route(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if p.route == "fused":
        return CA.launch(q, k, v, p, causal=causal, window=window,
                         q_offset=q_offset)
    CA.count("blockwise")
    return blockwise_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, block_k=block_k)


def blockwise_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None, q_offset: int = 0,
                              block_k: int = 1024) -> torch.Tensor:
    """The blockwise path of `blockwise_attention`, on any device: f32
    scores over `block_k` key blocks, the last one zero-padded."""
    b, sq, hh, dh = q.shape
    sk, kk = k.shape[1], k.shape[2]
    g = hh // kk
    scale = dh ** -0.5
    dev = q.device
    nb = max(1, (sk + block_k - 1) // block_k)
    qg = (q.float() * scale).reshape(b, sq, kk, g, dh)
    q_pos = q_offset + torch.arange(sq, device=dev)

    acc = torch.zeros((b, kk, g, sq, dh), dtype=torch.float32, device=dev)
    m_run = torch.full((b, kk, g, sq), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, kk, g, sq), dtype=torch.float32, device=dev)
    for blk in range(nb):
        lo = blk * block_k
        kblk = k[:, lo: lo + block_k].float()
        vblk = v[:, lo: lo + block_k].float()
        n = kblk.shape[1]
        if n < block_k:       # the reference zero-pads the last block
            pad = (0, 0, 0, 0, 0, block_k - n)
            kblk = torch.nn.functional.pad(kblk, pad)
            vblk = torch.nn.functional.pad(vblk, pad)
        k_pos = lo + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk)
        mask = (k_pos < sk)[None, :].expand(sq, block_k)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vblk)
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    # (B, K, G, Sq, h) -> (B, Sq, H, h)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hh, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Single-step attention over a KV cache, GQA-native.

    q: (B, 1, H, h); caches: (B, Sc, K, h); mask: (Sc,) or (B, Sc) bool,
    True = slot attendable.
    """
    b, sc, kk, dh = k_cache.shape
    hh = q.shape[2]
    g = hh // kk
    scale = dh ** -0.5
    qg = (q.float() * scale).reshape(b, kk, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    m = mask if mask.dim() == 2 else mask[None, :]
    s = torch.where(m[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, hh, dh).to(q.dtype)


def rolling_slot(pos: int, cache_size: int) -> int:
    """Write slot for a rolling (SWA) cache."""
    return pos % cache_size


def rolling_mask(pos: int, cache_size: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Validity mask (Sc,) for a rolling cache after writing `pos`.

    Slot s holds absolute position pos - ((pos - s) mod Sc); it is valid
    when that position is >= 0.
    """
    s = torch.arange(cache_size, device=device)
    kp = pos - torch.remainder(pos - s, cache_size)
    return kp >= 0


def linear_mask(pos: int, cache_size: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Validity mask for an append-only cache after writing at index `pos`."""
    return torch.arange(cache_size, device=device) <= pos
