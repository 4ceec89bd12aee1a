"""The WKV-6 scan's gradient (`rwkv6_scan.WKVScan`), held on the CPU.

Where autograd records, the router runs `WKVScan`: a forward that keeps
the state every `CK` tokens and a backward that walks the reverse
recurrence from those checkpoints, which on the CPU is
`rwkv6_scan_bwd_plain` (the card's backward kernel computes the same
recurrence).  Held here:

  * `torch.autograd.gradcheck` in float64, with and without s0, with a
    gradient on the final state, T not a multiple of CK, decays down to
    1e-12, a shared `(H, dh)` and a per-row bonus;
  * against `jax.grad` of the reference's oracle `ref.rwkv6_scan_ref`
    and of its model's `rwkv6_timemix` (whose `lax.scan` JAX
    differentiates), on the same numpy-seeded numbers: float32 on both
    sides, so within `rtol = atol = 1e-4` (`test_torch_rwkv6_scan.py`'s
    tolerance for the forward: sums in another order);
  * the same gradients as autograd through the plain loop itself, and
    bf16 strided views, within float32 rounding;
  * refusals, and `cuda_rwkv6_scan.plan_bwd` (the backward launch's
    layout arithmetic and cluster geometry, pure Python).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.kernels import cuda_rwkv6_scan as CW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as WKV  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

TOL = 1e-4


def _operands(seed, B, T, H, dh, dtype=torch.float64, w_lo=1e-12,
              state=True, per_row_u=False):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(0, 1, (B, T, H, dh)))
               .to(dtype).requires_grad_() for _ in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(np.log(w_lo), np.log(0.999),
                                            (B, T, H, dh)))).to(dtype)
    u = torch.from_numpy(rng.normal(0, 0.5, (B, H, dh) if per_row_u
                                    else (H, dh))).to(dtype)
    s0 = torch.from_numpy(rng.normal(0, 1, (B, H, dh, dh))).to(dtype) \
        if state else None
    return [r, k, v, w.requires_grad_(), u.requires_grad_(),
            None if s0 is None else s0.requires_grad_()]


@pytest.mark.parametrize("B,T,H,dh,state,per_row_u", [
    (2, 37, 2, 4, True, False),        # T past two checkpoints, not a multiple
    (1, 16, 3, 4, False, False),       # exactly one checkpoint chunk
    (2, 5, 1, 3, True, True),          # a bonus a row
    (1, 1, 2, 4, True, False),
])
def test_gradcheck_float64(B, T, H, dh, state, per_row_u):
    args = _operands(B * 100 + T, B, T, H, dh, state=state,
                     per_row_u=per_row_u)
    inputs = [a for a in args if a is not None]

    def f(*xs):
        it = iter(xs)
        full = [next(it) if a is not None else None for a in args]
        return WKV.rwkv6_scan(*full)        # y and the final state

    assert torch.autograd.gradcheck(f, inputs)


def test_gradcheck_at_tiny_decays():
    """Decays down to 1e-12 and one of exactly 0: nothing divides by w."""
    args = _operands(5, 1, 20, 2, 4, w_lo=1e-12)
    with torch.no_grad():
        args[3][0, 3] = 0.0
    assert torch.autograd.gradcheck(lambda *xs: WKV.rwkv6_scan(*xs), args)


def test_bh_layout_gradcheck():
    """The reference's `(BH, T, dh)` entry is the H = 1 case."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.normal(0, 1, (3, 19, 4))).requires_grad_()
          for _ in range(3)]
    w = torch.from_numpy(rng.uniform(0.01, 0.99, (3, 19, 4))) \
        .requires_grad_()
    u = torch.from_numpy(rng.normal(0, 0.5, (3, 4))).requires_grad_()
    s0 = torch.from_numpy(rng.normal(0, 1, (3, 4, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: WKV.rwkv6_scan(*a), (*xs, w, u, s0))


def _grads(fn, args, seed):
    """Gradients of `sum(y * gy) + sum(s * gs)` with fixed seeded
    cotangents."""
    y, s = fn(*args)
    rng = np.random.default_rng(seed)
    gy = torch.from_numpy(rng.normal(0, 1, tuple(y.shape))).to(y.dtype)
    gs = torch.from_numpy(rng.normal(0, 1, tuple(s.shape))).to(s.dtype)
    inputs = [a for a in args if a is not None]
    return torch.autograd.grad((y * gy).sum() + (s * gs).sum(), inputs)


@pytest.mark.parametrize("T", [1, 16, 33])
def test_equals_autograd_through_the_plain_loop(T):
    args = _operands(T, 2, T, 3, 8)
    got = _grads(WKV.rwkv6_scan, args, 7)
    want = _grads(WKV.rwkv6_scan_plain, args, 7)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("BH,T,dh", [(3, 20, 16), (2, 40, 8), (1, 1, 4)])
def test_matches_jax_grad_of_the_sequential_oracle(BH, T, dh):
    rng = np.random.default_rng(BH * 10 + T)
    r, k, v = (rng.normal(0, 1, (BH, T, dh)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, (BH, T, dh)).astype(np.float32)
    u = rng.normal(0, 0.5, (BH, dh)).astype(np.float32)
    gy = rng.normal(0, 1, (BH, T, dh)).astype(np.float32)
    gs = rng.normal(0, 1, (BH, dh, dh)).astype(np.float32)

    def loss(*a):
        y, s = ref.rwkv6_scan_ref(*a)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, w, u)]
    y, s = ops.rwkv6_scan(*ts)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (s * torch.from_numpy(gs)).sum(), ts)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=TOL,
                                   atol=TOL)


def test_matches_jax_grad_of_the_reference_timemix():
    """The model's time-mix, whose recurrence the reference runs as a
    `lax.scan`: gradients of every leaf and of the input."""
    rng = np.random.default_rng(11)
    B, S_, D, H = 2, 21, 32, 2
    r = 4
    p = {"mu_r": rng.uniform(0, 1, D), "mu_k": rng.uniform(0, 1, D),
         "mu_v": rng.uniform(0, 1, D), "mu_w": rng.uniform(0, 1, D),
         "mu_g": rng.uniform(0, 1, D),
         "lora_A": rng.normal(0, 0.1, (D, r)),
         **{f"lora_B_{n}": rng.normal(0, 0.1, (r, D)) for n in "rkvwg"},
         **{f"w_{n}": {"w": rng.normal(0, 0.2, (D, D))} for n in "rkvgo"},
         "w0": rng.normal(0, 1, D), "wA": rng.normal(0, 0.1, (D, r)),
         "wB": rng.normal(0, 0.1, (r, D)), "u": rng.normal(0, 0.5, D),
         "gn_scale": 1 + 0.1 * rng.normal(0, 1, D)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.normal(0, 1, (B, S_, D)).astype(np.float32)
    gout = rng.normal(0, 1, (B, S_, D)).astype(np.float32)

    def loss(pp, xx):
        out, _, _ = RS.rwkv6_timemix(pp, xx, H, None)
        return jnp.sum(out * gout)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    out, _, _ = S.rwkv6_timemix(tp, tx, H, None)
    leaves = jax.tree.leaves(tp)
    got = torch.autograd.grad((out * torch.from_numpy(gout)).sum(),
                              leaves + [tx])
    for g, w in zip(got, jax.tree.leaves(want_p) + [want_x]):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL * max(scale, 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_views_against_float64(dtype):
    """The model's strided `(B, T, H, dh)` views of one projection, bf16 or
    f32, decays to 1e-12: the gradients equal the float64 ones within
    float32 rounding, plus one bf16 rounding of dr, dk, dv."""
    rng = np.random.default_rng(4)
    B, T, H, dh = 2, 23, 3, 16
    big = torch.from_numpy(rng.normal(0, 1, (B, T, 3 * H * dh + 5))
                           .astype(np.float32)).to(dtype).requires_grad_()
    r, k, v = (big[..., x * H * dh:(x + 1) * H * dh].unflatten(-1, (H, dh))
               for x in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(np.log(1e-12), np.log(0.999),
                                            (B, T, H, dh)))
                         .astype(np.float32)).requires_grad_()
    u = torch.from_numpy(rng.normal(0, 0.5, (H, dh)).astype(np.float32)) \
        .requires_grad_()
    gy = torch.from_numpy(rng.normal(0, 1, (B, T, H, dh)).astype(np.float32))
    y, _ = WKV.rwkv6_scan(r, k, v, w, u)
    got = torch.autograd.grad((y * gy).sum(), (big, w, u))
    b64 = big.detach().double().requires_grad_()
    r6, k6, v6 = (b64[..., x * H * dh:(x + 1) * H * dh].unflatten(-1, (H, dh))
                  for x in range(3))
    w6, u6 = (a.detach().double().requires_grad_() for a in (w, u))
    y6, _ = WKV.rwkv6_scan(r6, k6, v6, w6, u6)
    want = torch.autograd.grad((y6 * gy.double()).sum(), (b64, w6, u6))
    for g, x in zip(got, want):
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-4
        scale = float(x.abs().max())
        np.testing.assert_allclose(g.double().numpy(), x.numpy(), rtol=rel,
                                   atol=1e-4 * scale)


def test_checkpoints_are_the_states_before_every_ck_tokens():
    args = [a.detach() for a in _operands(9, 2, 40, 2, 4)]
    ck = torch.empty((2, 2, WKV.n_checkpoints(40), 4, 4),
                     dtype=torch.float64)
    WKV.rwkv6_scan_plain(*args, ckpt=ck)
    assert WKV.n_checkpoints(40) == 3 and WKV.CK == 16
    torch.testing.assert_close(ck[:, :, 0], args[5])
    for c in (1, 2):
        _, s = WKV.rwkv6_scan_plain(*(a[:, :c * 16] for a in args[:4]),
                                    args[4], args[5])
        torch.testing.assert_close(ck[:, :, c], s, rtol=0, atol=0)


def test_no_gradient_runs_the_plain_path():
    """Under no_grad (serving) the router runs the plain version as
    before, and the decode path may write the state in place."""
    args = [a.detach() for a in _operands(2, 1, 5, 2, 4)]
    cache = args[5].clone()
    y, s = WKV.rwkv6_scan(*args[:5], cache, cache)
    assert s.data_ptr() == cache.data_ptr()
    y2, s2 = WKV.rwkv6_scan(*args)
    assert y.grad_fn is None and torch.equal(y, y2) and torch.equal(s, s2)


def test_in_place_state_refused_under_autograd():
    args = _operands(2, 1, 5, 2, 4)
    with pytest.raises(ValueError, match="autograd"):
        WKV.rwkv6_scan(*args, torch.zeros_like(args[5]))


def test_unused_outputs_get_no_gradient_work():
    """A loss on y alone (the model's case) passes no state gradient: the
    backward runs with ds = None, and s0's gradient is still G_0."""
    args = _operands(6, 1, 18, 2, 4)
    y, _ = WKV.rwkv6_scan(*args)
    g = torch.autograd.grad(y.sum(), args[5])[0]
    y2, s2 = WKV.rwkv6_scan_plain(*args)
    g2 = torch.autograd.grad(y2.sum(), args[5])[0]
    torch.testing.assert_close(g, g2, rtol=1e-10, atol=1e-12)


def test_plan_bwd_reads_the_model_layout():
    B, T, H, dh = 2, 19, 4, 64
    big = torch.zeros((B, T, 3 * H * dh), dtype=torch.bfloat16)
    r, k, v = (big[..., x * H * dh:(x + 1) * H * dh].unflatten(-1, (H, dh))
               for x in range(3))
    w = torch.zeros((B, T, H, dh))
    p = CW.plan_bwd(r, k, v, w, torch.zeros((H, dh)))
    D3 = 3 * H * dh
    assert p.steps == (T * D3, D3) * 3 + (T * H * dh, H * dh, 0)
    assert (p.B, p.T, p.H, p.dh, p.bf16, p.design) == (B, T, H, dh, True,
                                                       "cp_async")
    # a row is a cluster of 2 CTAs of 32 value columns, 128 threads each
    # (a 2 x 8 tile a thread): B H P CTAs, and no scratch in device memory
    assert (p.clusters, p.threads, p.blocks) == (2, 128, B * H * 2)
    assert not {"hist_floats", "scratch_bytes"} & set(p._fields)
    # BwdSmem<64, bf16>: the chunk as staged (r, k bf16 and w f32 all
    # rows, v bf16 and dy f32 the CTA's 32 columns), its float32 planes,
    # the states before 4 of a half's 8 tokens (the thread's 2 x 8 tile),
    # the exchanged sums of two halves (a float4 a key row and e_t's share
    # a token), each warp's dv, u, c, e -- two CTAs in an SM's 228 KB
    assert p.smem_bytes == (2 * (2 * 16 * 64 + 16 * 32) + 4 * (
        16 * 64 + 16 * 32 + 3 * 16 * 64 + 2 * 16 * 32 + 4 * 2 * 128 * 8
        + 2 * 8 * (4 * 64 + 4) + 8 * 4 * 32 + 64 + 32)) == 81536
    assert 2 * (p.smem_bytes + 1024) <= 228 * 1024
    p32 = CW.plan_bwd(*(a.float() for a in (r, k, v)), w,
                      torch.zeros((H, dh)))
    assert p32.smem_bytes == p.smem_bytes + 2 * (2 * 16 * 64 + 16 * 32)
    assert 2 * (p32.smem_bytes + 1024) <= 228 * 1024
    p16 = CW.plan_bwd(*(a[..., :16].contiguous() for a in (r, k, v, w)),
                      torch.zeros((B, H, 16)))
    assert p16.steps[-1] == H * 16
    assert (p16.clusters, p16.threads, p16.blocks) == (1, 32, B * H)
    assert p16.smem_bytes == (2 * (2 * 16 * 16 + 16 * 16) + 4 * (
        16 * 16 + 16 * 16 + 3 * 16 * 16 + 2 * 16 * 16 + 4 * 2 * 32 * 4
        + 2 * 8 * (4 * 16 + 4) + 8 * 1 * 16 + 16 + 32))
    for q in (p, p32, p16):
        assert q.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("offset,design", [(0, "cp_async"), (1, "element")])
def test_plan_bwd_stages_16_bytes_only_on_aligned_operands(offset, design):
    """16-byte staging needs every operand row and token, dy and the
    checkpoints on 16-byte boundaries; one element off, the kernel stages
    element by element."""
    B, T, H, dh = 2, 19, 3, 64
    big = torch.zeros((B, T, 3 * H * dh + offset), dtype=torch.bfloat16)
    r, k, v = (big[..., offset + x * H * dh:offset + (x + 1) * H * dh]
               .unflatten(-1, (H, dh)) for x in range(3))
    w = torch.zeros((B, T, H, dh))
    u = torch.zeros((H, dh))
    ck = torch.zeros((B, H, WKV.n_checkpoints(T), dh, dh))
    dy = torch.zeros((B, T, H, dh))
    assert CW.plan_bwd(r, k, v, w, u, dy, ck).design == design
    # dy or the checkpoints off a boundary alone
    flat = torch.zeros(dy.numel() + 1)
    off = flat[1:].view(dy.shape)
    assert CW.plan_bwd(*(a.contiguous() for a in (r, k, v)), w, u, off,
                       ck).design == "element"
    assert CW.plan_bwd(*(a.contiguous() for a in (r, k, v)), w, u, dy,
                       torch.zeros(ck.numel() + 1)[1:].view(ck.shape)
                       ).design == "element"


def test_backward_launches_are_counted_apart():
    assert set(CW.LAUNCHES) == {"rwkv6_scan", "rwkv6_scan_bwd"}
    CW.LAUNCHES["rwkv6_scan_bwd"] = 3
    CW.reset_launches()
    assert CW.LAUNCHES == {"rwkv6_scan": 0, "rwkv6_scan_bwd": 0}
