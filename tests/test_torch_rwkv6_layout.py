"""The WKV-6 scan on the model's own layout, held against `repro.kernels`.

The port's scan takes r, k, v, w as `(B, T, H, dh)` views with any step
between batch rows and tokens (r, k, v in float32 or bfloat16), the bonus
u as one `(H, dh)` row for the whole batch (`u_sb = 0`) or `(B, H, dh)`,
and writes the final state into `s_out`, which may alias `s0`.  The same
numpy-seeded numbers go through the plain version on such views and
through the reference's sequential oracle `ref.rwkv6_scan_ref` on the
`(BH, T, dh)` arrays it takes.  bfloat16 operands are drawn as bfloat16
values, so widening them is exact and both sides see the same numbers.

Tolerance against the oracle: `rtol = atol = 1e-4`, as in
`test_torch_rwkv6_scan.py` (the same float32 recurrence, sums over the key
dimension in another order).  `cuda_rwkv6_scan.plan`, the kernel
wrapper's layout arithmetic, is pure Python and is checked here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import cuda_rwkv6_scan as CW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as WKV  # noqa: E402

TOL = 1e-4


def _operands(seed, B, T, H, dh, dtype=torch.float32, w_lo=1e-12,
              stride_pad=0):
    """r, k, v as slices of one wider `(B, T + 2, 3 H dh + stride_pad)`
    projection (steps that are not (T, H, dh)'s own), w `(B, T, H, dh)`
    in float32 with decays spread log-uniformly over (w_lo, 0.999)."""
    rng = np.random.default_rng(seed)
    D = H * dh
    big = torch.from_numpy(rng.normal(0, 1, (B, T + 2, 3 * D + stride_pad))
                           .astype(np.float32)).to(dtype)
    r, k, v = (big[:, :T, x * D:(x + 1) * D].unflatten(-1, (H, dh))
               for x in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(np.log(w_lo), np.log(0.999),
                                            (B, T, H, dh)))
                         .astype(np.float32))
    return r, k, v, w


def _bh_first(a: torch.Tensor) -> np.ndarray:
    """`(B, T, H, dh)` -> the reference's `(B*H, T, dh)` float32 array."""
    B, T, H, dh = a.shape
    return a.float().permute(0, 2, 1, 3).reshape(B * H, T, dh).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dh", [(2, 9, 3, 16), (1, 20, 2, 64),
                                      (3, 1, 4, 16), (2, 17, 1, 16)])
def test_strided_views_match_sequential_oracle(dtype, B, T, H, dh):
    r, k, v, w = _operands(B * 100 + T + dh, B, T, H, dh, dtype)
    for n, step, want in zip((B, T), r.stride()[:2],
                             ((T + 2) * 3 * H * dh, 3 * H * dh)):
        assert n == 1 or step == want      # a size-1 step is never taken
    u = torch.from_numpy(np.random.default_rng(T).normal(0, 0.5, (H, dh))
                         .astype(np.float32))
    y, s = ops.rwkv6_scan_heads(r, k, v, w, u)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, T, H, dh) and tuple(s.shape) == (B, H, dh,
                                                                   dh)
    y_r, s_r = ref.rwkv6_scan_ref(
        *(jnp.asarray(_bh_first(a)) for a in (r, k, v, w)),
        jnp.asarray(np.tile(u.numpy(), (B, 1))))
    np.testing.assert_allclose(_bh_first(y), np.asarray(y_r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s.reshape(B * H, dh, dh).numpy(),
                               np.asarray(s_r), rtol=TOL, atol=TOL)


def test_per_batch_bonus_matches_sequential_oracle():
    """u `(B, H, dh)`: row (b, h) reads its own bonus."""
    B, T, H, dh = 2, 6, 3, 16
    r, k, v, w = _operands(5, B, T, H, dh)
    u = torch.from_numpy(np.random.default_rng(6).normal(0, 0.5, (B, H, dh))
                         .astype(np.float32))
    s0 = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (B, H, dh, dh)).astype(np.float32))
    y, s = WKV.rwkv6_scan(r, k, v, w, u, s0)
    # the oracle has no initial state: run it from s0 by hand in float64
    y_r, s_r = WKV.rwkv6_scan_plain(
        *(torch.from_numpy(_bh_first(a)).double() for a in (r, k, v, w)),
        u.reshape(B * H, dh).double(), s0.reshape(B * H, dh, dh).double())
    np.testing.assert_allclose(_bh_first(y), y_r.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.reshape(B * H, dh, dh).numpy(),
                               s_r.numpy(), rtol=TOL, atol=TOL)
    y0, _ = WKV.rwkv6_scan(r, k, v, w, u)
    y_o, _ = ref.rwkv6_scan_ref(
        *(jnp.asarray(_bh_first(a)) for a in (r, k, v, w)),
        jnp.asarray(u.reshape(B * H, dh).numpy()))
    np.testing.assert_allclose(_bh_first(y0), np.asarray(y_o), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("T", [0, 1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_written_in_place_equals_out_of_place(T, dtype):
    """`s_out` aliasing `s0` (the decode cache) gives what a fresh state
    gives, bit for bit, and is the tensor returned."""
    B, H, dh = 2, 3, 16
    r, k, v, w = _operands(T + 11, B, T, H, dh, dtype)
    u = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (H, dh))
                         .astype(np.float32))
    s0 = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (B, H, dh, dh)).astype(np.float32))
    y, s = WKV.rwkv6_scan(r, k, v, w, u, s0)
    cache = s0.clone()
    y2, s2 = WKV.rwkv6_scan(r, k, v, w, u, cache, cache)
    assert s2 is cache
    assert torch.equal(y2, y) and torch.equal(cache, s)
    out = torch.full_like(s0, float("nan"))
    y3, s3 = WKV.rwkv6_scan(r, k, v, w, u, s0, out)
    assert s3 is out and torch.equal(out, s) and torch.equal(y3, y)


def test_bh_layout_is_the_single_head_case():
    """The reference's `(BH, T, dh)` operands run as H = 1 with
    `u_sb = dh` and give what the same rows in `(B, T, H, dh)` give."""
    B, T, H, dh = 2, 5, 3, 16
    r, k, v, w = _operands(3, B, T, H, dh)
    u = torch.from_numpy(np.random.default_rng(4).normal(0, 0.5, (H, dh))
                         .astype(np.float32))
    y, s = WKV.rwkv6_scan(r, k, v, w, u)
    flat = [torch.from_numpy(_bh_first(a)) for a in (r, k, v, w)]
    u_bh = u.repeat(B, 1)
    y3, s3 = ops.rwkv6_scan(*flat, u_bh)
    assert tuple(y3.shape) == (B * H, T, dh)
    np.testing.assert_allclose(y3.numpy(), _bh_first(y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s3.numpy(), s.reshape(B * H, dh, dh).numpy(),
                               rtol=TOL, atol=TOL)
    p = CW.plan(*(a.unsqueeze(2) for a in flat), u_bh.unsqueeze(1))
    assert (p.B, p.T, p.H, p.dh) == (B * H, T, 1, dh)
    assert p.steps == (T * dh, dh) * 4 + (dh, T * dh, dh)


def test_plan_reads_the_model_layout():
    """rwkv6-7b's time-mix at prefill: r, k, v bf16 (B, T, H, dh) views
    of `(B, T, D)` projections, w float32, u `(H, dh)` -> token step D,
    batch step T D, `u_sb = 0`, 16-byte staging, a block a (b, h) row."""
    B, T, H, dh = 8, 96, 64, 64
    D = H * dh
    r, k, v = (torch.empty((B, T, D), dtype=torch.bfloat16)
               .view(B, T, H, dh) for _ in range(3))
    w = torch.empty((B, T, D)).view(B, T, H, dh)
    p = CW.plan(r, k, v, w, torch.empty((H, dh)))
    assert p.steps == (T * D, D) * 4 + (0, T * D, D)
    assert p.bf16 and p.design == "cp_async"
    assert p.blocks == B * H
    p = CW.plan(r, k, v, w, torch.empty((B, H, dh)))
    assert p.steps[8] == H * dh


def test_plan_stages_element_by_element_off_a_16_byte_boundary():
    B, T, H, dh = 2, 3, 2, 16
    flat = torch.zeros(B * T * H * dh + 4)
    aligned = flat[:-4].view(B, T, H, dh)
    assert CW.plan(aligned, aligned, aligned, aligned,
                   torch.empty((H, dh))).design in ("cp_async", "element")
    off = flat[1:-3].view(B, T, H, dh)       # 4 bytes past the base
    assert off.data_ptr() % 16 == (aligned.data_ptr() + 4) % 16
    if aligned.data_ptr() % 16 == 0:
        assert CW.plan(aligned, aligned, aligned, aligned,
                       torch.empty((H, dh))).design == "cp_async"
        assert CW.plan(off, aligned, aligned, aligned,
                       torch.empty((H, dh))).design == "element"
        states = torch.zeros(B * H * dh * dh + 4)
        state = states[:-4].view(B, H, dh, dh)
        odd_state = states[1:-3].view(B, H, dh, dh)        # 4 bytes past
        for s0, s_out, design in ((state, state, "cp_async"),
                                  (odd_state, state, "element"),
                                  (None, odd_state, "element")):
            assert CW.plan(aligned, aligned, aligned, aligned,
                           torch.empty((H, dh)), s0, s_out).design == design
    # a token step that is not a multiple of 16 bytes
    big = torch.zeros((B, T, H * dh + 1), dtype=torch.bfloat16)
    odd = big[:, :, :H * dh].unflatten(-1, (H, dh))
    assert CW.plan(odd, odd, odd, odd.float(),
                   torch.empty((H, dh))).design == "element"


def test_plan_ignores_the_steps_of_size_one_dimensions():
    """A step never taken (T = 1 at decode, B = 1) does not force element
    staging, whatever torch reports for it."""
    H, dh = 4, 64
    base = torch.zeros((2, 3, H, dh))
    one_token = base[:, 1:2]                       # T = 1
    odd_t = torch.as_strided(base, (2, 1, H, dh), (3 * H * dh, 7, dh, 1))
    for a in (one_token, odd_t):
        p = CW.plan(a, a, a, a, torch.empty((H, dh)))
        assert p.T == 1
        assert p.design == ("cp_async" if a.data_ptr() % 16 == 0
                            else "element")
