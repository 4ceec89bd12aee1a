"""The fused attention kernel (`kernels/cuda_attention.py`,
`csrc/attention.cu`): its routing and tile arithmetic on the CPU, and the
kernel against a float64 attention on the card.

On the CPU: `plan`'s route for each kind of call; `rows_see_a_key` and the
tile ranges against a brute-force mask; the causal tile count; the
counters; and the kernel's walk emulated in torch (stacked GQA rows, the
tile ranges and the full-tile predicate, online softmax with -inf masks, P
split into three bf16 terms), held to the float64 attention as the kernel
is.  On the card (`cuda`-marked, skipped without a CUDA device):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_kernel.py

holds the kernel's largest error against the float64 attention of the same
bf16 inputs to at most twice the blockwise path's, at qwen2.5-14b's groups
and the other shapes that route to it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_attention as CA  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.roofline import kernel_model as KM  # noqa: E402

BF16 = torch.bfloat16


def _plan(q_shape=(2, 64, 8, 128), k_shape=(2, 64, 2, 128), *,
          dtypes=(BF16,) * 3, device_type="cuda", recording=False,
          causal=True, window=None, q_offset=0):
    return CA.plan(q_shape, k_shape, dtypes=dtypes, device_type=device_type,
                   recording=recording, causal=causal, window=window,
                   q_offset=q_offset)


def _visible(sq, sk, causal, window, q_offset):
    """(sq, sk) bool: the mask of the blockwise path, without its pad."""
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    m = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= qp - kp < window
    return m


def _attention64(q, k, v, causal, window, q_offset):
    """Float64 attention of the same inputs, over the visible keys."""
    b, sq, hh, dh = q.shape
    g = hh // k.shape[2]
    qd = q.double()
    kd = k.double().repeat_interleave(g, dim=2)
    vd = v.double().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(dh)
    mask = _visible(sq, k.shape[1], causal, window, q_offset).to(s.device)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


# ---------------------------------------------------------------------------
# Routing (CPU)


@pytest.mark.parametrize("kw,why", [
    ({"device_type": "cpu"}, "tensors on cpu"),
    ({"dtypes": (torch.float32,) * 3}, "not all bf16"),
    ({"dtypes": (BF16, BF16, torch.float32)}, "not all bf16"),
    ({"recording": True}, "autograd records"),
    ({"q_shape": (2, 64, 8, 96), "k_shape": (2, 64, 2, 96)}, "head size 96"),
    ({"q_offset": -1}, "sees no key"),
    ({"window": 8, "k_shape": (2, 40, 2, 128), "q_offset": 40,
      "causal": False}, "sees no key"),
    ({"q_shape": (2, 64, 6, 128), "k_shape": (2, 64, 4, 128)}, "shape"),
])
def test_plan_routes_to_blockwise(kw, why):
    p = _plan(**kw)
    assert p.route == "blockwise" and why in p.why


@pytest.mark.parametrize("q_shape,k_shape,causal,window,q_offset,positions", [
    ((8, 2048, 40, 128), (8, 2048, 8, 128), True, None, 0, 25),  # qwen
    ((2, 100, 16, 64), (2, 1500, 16, 64), False, None, 0, 128),  # whisper
    ((1, 300, 32, 64), (1, 800, 8, 64), True, 128, 500, 32),
])
def test_plan_routes_bf16_inference_on_the_card_to_fused(
        q_shape, k_shape, causal, window, q_offset, positions):
    p = _plan(q_shape, k_shape, causal=causal, window=window,
              q_offset=q_offset)
    assert p == CA.Plan("fused", "", positions,
                        (-(-q_shape[1] // positions), k_shape[2],
                         q_shape[0]))


def test_route_reads_grad_mode_and_device():
    q = torch.zeros(1, 8, 4, 64, dtype=BF16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 64, dtype=BF16)
    kw = {"causal": True, "window": None, "q_offset": 0}
    assert "autograd" in CA.plan(
        tuple(q.shape), tuple(k.shape), dtypes=(BF16,) * 3,
        device_type="cuda", recording=torch.is_grad_enabled()
        and q.requires_grad, **kw).why
    assert CA.route(q, k, k, **kw).why == "tensors on cpu"
    with torch.inference_mode():
        assert CA.route(q.detach(), k, k, **kw).route == "blockwise"


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (7, 7, True, None, 0), (7, 7, True, None, -1), (5, 9, True, 3, 4),
    (5, 9, False, 3, 8), (5, 9, False, 3, 9), (5, 9, False, 3, 12),
    (4, 6, True, 1, 2), (4, 6, False, None, -10), (3, 0, False, None, 0),
    (6, 6, True, 0, 0), (6, 3, True, 2, 3), (6, 3, True, 2, 4),
])
def test_rows_see_a_key_matches_the_mask(sq, sk, causal, window, q_offset):
    want = bool(_visible(sq, sk, causal, window, q_offset).any(1).all()) \
        if sk else False
    assert CA.rows_see_a_key(sq, sk, causal, window, q_offset) == want


# ---------------------------------------------------------------------------
# Tile arithmetic (CPU)


@pytest.mark.parametrize("sq,sk,causal,window,q_offset,g", [
    (777, 777, True, None, 0, 5), (200, 1500, False, None, 0, 1),
    (1000, 1000, True, 300, 0, 4), (300, 800, True, None, 500, 8),
    (130, 130, False, 70, 0, 2), (64, 200, True, 100, 136, 1),
])
def test_tile_ranges_cover_exactly_the_visible_tiles(sq, sk, causal, window,
                                                     q_offset, g):
    """Each warpgroup's range holds every tile with a key visible to one
    of its rows and no tile masked for all of them."""
    vis = _visible(sq, sk, causal, window, q_offset)
    positions = CA.CTA_ROWS // g
    ranges = iter(CA.tile_ranges(sq, sk, causal=causal, window=window,
                                 q_offset=q_offset, g=g))
    for p0 in range(0, sq, positions):
        rows = min(positions, sq - p0) * g
        for first in range(0, rows, CA.WG_ROWS):
            last = min(first + CA.WG_ROWS, rows) - 1
            seen = vis[p0 + first // g: p0 + last // g + 1].any(0)
            tiles = {int(j) // CA.BLOCK_N for j in torch.nonzero(seen)}
            lo, hi = next(ranges)
            assert tiles == set(range(lo, hi))
    assert next(ranges, None) is None


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (777, 777, True, None, 0), (200, 1500, False, None, 0),
    (1000, 1000, True, 300, 0), (300, 800, True, None, 500),
    (130, 130, False, 70, 0),
])
def test_attention_bound_counts_the_visible_pairs(sq, sk, causal, window,
                                                  q_offset):
    rl = KM.attention_roofline(2, sq, sk, 8, 2, 64, causal, window, q_offset)
    pairs = int(_visible(sq, sk, causal, window, q_offset).sum())
    assert rl.ops == 4 * 2 * 8 * 64 * pairs
    assert rl.bytes_accessed == 2 * 2 * 64 * (2 * sq * 8 + 2 * sk * 2)
    assert rl.ops_per_s == KM.BF16_FLOP_PER_S


def test_causal_square_computes_about_half_the_tiles():
    full = CA.tiles_computed(2048, 2048, causal=False, window=None,
                             q_offset=0, g=5)
    causal = CA.tiles_computed(2048, 2048, causal=True, window=None,
                               q_offset=0, g=5)
    assert 0.45 < causal / full < 0.56


def test_a_512_token_prompt_never_touches_a_1024_key_blocks_pad():
    """The blockwise path scores 1,024 keys a row at `block_k` 1,024 (the
    pad masked); the kernel's tiles end at the prompt's 512th key."""
    ranges = CA.tile_ranges(512, 512, causal=True, window=None, q_offset=0,
                            g=5)
    assert max(hi for _, hi in ranges) * CA.BLOCK_N == 512
    assert CA.tiles_computed(512, 512, causal=True, window=None, q_offset=0,
                             g=5) * CA.BLOCK_N < len(ranges) * 1024 / 2


# ---------------------------------------------------------------------------
# Counters (CPU)


def test_counters_count_the_blockwise_route():
    CA.reset_launches()
    q = torch.randn(1, 8, 4, 16)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    ATT.blockwise_attention(q, k, v)
    ATT.blockwise_attention(q.to(BF16), k.to(BF16), v.to(BF16))
    assert CA.LAUNCHES == {"attention": 2}
    assert CA.VARIANT_LAUNCHES == {"fused": 0, "blockwise": 2}
    CA.reset_launches()
    assert CA.LAUNCHES == {"attention": 0}


# ---------------------------------------------------------------------------
# The kernel's walk, emulated (CPU)


def _tile_full(t, q_lo, q_hi, sk, causal, window):
    first, last = t * CA.BLOCK_N, t * CA.BLOCK_N + CA.BLOCK_N - 1
    return last < sk and (not causal or last <= q_lo) and \
        (window is None or q_hi - first < window)


def _bf16(x):
    return x.to(BF16).float()


def _walk(q, k, v, causal, window, q_offset):
    """`attention_fwd_kernel`'s arithmetic in torch: per (batch row, KV
    head, CTA, warpgroup) the stacked rows, the tile walk, the mask only
    where a tile is not full, exp2 of scaled f32 scores, P in three bf16
    terms (whose sum must be P exactly), f32 sums."""
    b, sq, hh, dh = q.shape
    sk, kk = k.shape[1], k.shape[2]
    g = hh // kk
    positions = CA.CTA_ROWS // g
    scale = np.float32(CA.LOG2E * dh ** -0.5)
    out = torch.zeros(b, sq, hh, dh, dtype=BF16)
    nt = -(-sk // CA.BLOCK_N)
    kp = torch.zeros(b, nt * CA.BLOCK_N, kk, dh)
    vp = torch.zeros_like(kp)
    kp[:, :sk], vp[:, :sk] = k.float(), v.float()
    for bi in range(b):
        for h in range(kk):
            for p0 in range(0, sq, positions):
                rows = min(positions, sq - p0) * g
                for first in range(0, rows, CA.WG_ROWS):
                    r = torch.arange(first, min(first + CA.WG_ROWS, rows))
                    pos, head = p0 + r // g, h * g + r % g
                    qr = q[bi, pos, head].float()
                    qp = q_offset + pos
                    q_lo, q_hi = int(qp[0]), int(qp[-1])
                    lo, hi = CA.key_tiles(q_lo, q_hi, sk, causal, window)
                    m = torch.full((len(r),), -math.inf)
                    l = torch.zeros(len(r))
                    o = torch.zeros(len(r), dh)
                    for t in range(lo, hi):
                        keys = slice(t * CA.BLOCK_N, (t + 1) * CA.BLOCK_N)
                        s = (qr.double() @ kp[bi, keys, h].double().T).float()
                        x = s * scale
                        if not _tile_full(t, q_lo, q_hi, sk, causal, window):
                            kpos = torch.arange(keys.start, keys.stop)
                            vis = (kpos < sk)[None, :].expand(len(r), -1)
                            if causal:
                                vis = vis & (kpos[None, :] <= qp[:, None])
                            if window is not None:
                                vis = vis & (qp[:, None] - kpos[None, :]
                                             < window)
                            x = x.masked_fill(~vis, -math.inf)
                        mn = torch.maximum(m, x.amax(1))
                        mu = torch.where(mn == -math.inf, 0.0, mn)
                        c = torch.exp2(m - mu)
                        p = torch.exp2(x - mu[:, None])
                        hi_ = _bf16(p)
                        r1 = p - hi_
                        mid = _bf16(r1)
                        lo_ = _bf16(r1 - mid)
                        assert torch.equal(hi_ + mid + lo_, p)
                        pv = sum((part.double() @ vp[bi, keys, h].double())
                                 for part in (hi_, mid, lo_)).float()
                        l = l * c + p.sum(1)
                        o = o * c[:, None] + pv
                        m = mn
                    out[bi, pos, head] = (o / l.clamp(min=1e-30)[:, None]
                                          ).to(BF16)
    return out


@pytest.mark.parametrize("b,sq,sk,hh,kk,dh,causal,window,q_offset", [
    (1, 150, 150, 10, 2, 64, True, None, 0),      # G 5, ragged last tile
    (1, 70, 300, 2, 2, 64, False, None, 0),       # cross-attention, G 1
    (1, 200, 200, 4, 1, 64, True, 70, 0),         # window
    (1, 60, 190, 8, 2, 64, True, None, 130),      # q_offset
])
def test_the_kernels_walk_matches_float64_as_blockwise_does(
        b, sq, sk, hh, kk, dh, causal, window, q_offset):
    g = torch.Generator().manual_seed(sq * 7 + sk)
    q = torch.randn(b, sq, hh, dh, generator=g).to(BF16)
    k = torch.randn(b, sk, kk, dh, generator=g).to(BF16)
    v = torch.randn(b, sk, kk, dh, generator=g).to(BF16)
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    want = _attention64(q, k, v, **kw)
    walk = _walk(q, k, v, **kw)
    blockwise = ATT.blockwise_attention(q, k, v, block_k=128, **kw)
    err = float((walk.double() - want).abs().max())
    assert err <= 2 * float((blockwise.double() - want).abs().max())


# ---------------------------------------------------------------------------
# The kernel on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


CARD_CASES = [  # b, sq, sk, H, K, dh, causal, window, q_offset
    (8, 2048, 2048, 40, 8, 128, True, None, 0),   # qwen2.5-14b's groups
    (4, 1024, 1024, 40, 8, 128, True, None, 0),
    (8, 512, 512, 40, 8, 128, True, None, 0),
    (2, 777, 777, 40, 8, 128, True, None, 0),     # not a tile multiple
    (2, 448, 1500, 16, 16, 64, False, None, 0),   # whisper cross-attention
    (2, 1000, 1000, 32, 8, 64, True, 300, 0),     # window
    (2, 300, 800, 40, 8, 128, True, None, 500),   # q_offset
    (2, 1024, 1024, 16, 16, 128, True, None, 0),  # G 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hh,kk,dh,causal,window,q_offset",
                         CARD_CASES)
def test_kernel_within_twice_blockwise_error(cuda, b, sq, sk, hh, kk, dh,
                                             causal, window, q_offset):
    """The routed call runs the kernel once; its output has the blockwise
    path's shape and dtype, (B, Sq, H, dh) contiguous, and its largest
    error against float64 is at most twice the blockwise path's."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk + hh)
    q = torch.randn(b, sq, hh, dh, device=cuda, generator=g).to(BF16)
    k = torch.randn(b, sk, kk, dh, device=cuda, generator=g).to(BF16)
    v = torch.randn(b, sk, kk, dh, device=cuda, generator=g).to(BF16)
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    with torch.inference_mode():
        CA.reset_launches()
        got = ATT.blockwise_attention(q, k, v, **kw)
        assert CA.VARIANT_LAUNCHES == {"fused": 1, "blockwise": 0}
        plain = ATT.blockwise_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == plain.shape == q.shape and got.dtype == plain.dtype
    assert got.is_contiguous()
    err = plain_err = 0.0
    for i in range(b):
        want = _attention64(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
        err = max(err, float((got[i:i + 1].double() - want).abs().max()))
        plain_err = max(plain_err,
                        float((plain[i:i + 1].double() - want).abs().max()))
    assert err <= 2 * plain_err, (err, plain_err)


@pytest.mark.cuda
def test_each_route_counts_on_the_card(cuda):
    q = torch.randn(1, 70, 8, 64, device=cuda)
    k, v = torch.randn(1, 70, 2, 64, device=cuda), torch.randn(
        1, 70, 2, 64, device=cuda)
    qb, kb, vb = q.to(BF16), k.to(BF16), v.to(BF16)
    CA.reset_launches()
    with torch.inference_mode():
        ATT.blockwise_attention(qb, kb, vb)                   # fused
        ATT.blockwise_attention(q, k, v)                      # f32
    ATT.blockwise_attention(qb.requires_grad_(), kb, vb)      # recording
    assert CA.LAUNCHES == {"attention": 3}
    assert CA.VARIANT_LAUNCHES == {"fused": 1, "blockwise": 2}
