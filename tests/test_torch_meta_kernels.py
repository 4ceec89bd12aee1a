"""The kernel routers on the `meta` device (`repro_torch.kernels.meta`).

A meta tensor has a shape and a dtype and no data.  On meta operands the
ternary-matmul and WKV-6 routers return the card path's outputs (shapes
and dtypes; here held against the CPU plain versions' outputs on the
same shapes) and report each call, with the sizes that price it, to the
costing's sinks.  The ternary router refuses autograd on meta as on the
card; the WKV-6 autograd function runs its meta forward (with the
checkpoint buffer the card path keeps) and backward.  The CPU paths are
unchanged: the routers still return the plain versions' results there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.ternary import pack_ternary  # noqa: E402
from repro_torch.kernels import meta as KM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as WKV  # noqa: E402
from repro_torch.kernels import ternary_matmul as TM  # noqa: E402

META = torch.device("meta")


def calls():
    seen = []
    return seen, lambda: KM.recording(
        lambda name, sizes: seen.append((name, sizes)))


def like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def sig(t: torch.Tensor):
    return tuple(t.shape), t.dtype


def ternary_operands(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dtype)
    codes = torch.from_numpy(rng.integers(-1, 2, (K, N)).astype(np.int8))
    w2 = pack_ternary(codes)
    scale = torch.from_numpy(rng.random((1, N), np.float32))
    return x, w2, scale


@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (9, 128, 48), (0, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ternary_meta_matches_the_cpu_output(M, K, N, dtype):
    x, w2, scale = ternary_operands(M, K, N, dtype)
    cpu = TM.ternary_matmul(x, w2, scale)
    assert torch.equal(cpu, TM.ternary_matmul_plain(x, w2, scale))
    seen, rec = calls()
    with rec():
        out = TM.ternary_matmul(like(x), like(w2), like(scale))
    assert out.device == META and sig(out) == sig(cpu)
    assert seen == [("ternary_matmul", {"M": M, "K": K, "N": N,
                                        "x_bytes": x.element_size()})]
    # through the model's entry point, any leading shape
    with rec():
        y = ops.ternary_matmul(like(x).reshape(1, M, K), like(w2),
                               like(scale))
    assert tuple(y.shape) == (1, M, N) and len(seen) == 2


def test_ternary_meta_refuses_autograd_as_the_card_does():
    x, w2, scale = ternary_operands(4, 32, 8, torch.float32)
    xm = like(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        TM.ternary_matmul(xm, like(w2), like(scale))
    with torch.no_grad():
        assert TM.ternary_matmul(xm, like(w2), like(scale)).device == META


def wkv_operands(B, T, H, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    r, k, v = (f(B, T, H, dh).to(dtype) for _ in range(3))
    w = f(B, T, H, dh, lo=0.5, hi=0.99)
    u = f(H, dh)
    s0 = f(B, H, dh, dh)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_meta_matches_the_cpu_output(dtype, with_s0):
    r, k, v, w, u, s0 = wkv_operands(2, 5, 3, 4, dtype)
    s0 = s0 if with_s0 else None
    y, s = WKV.rwkv6_scan(r, k, v, w, u, s0)
    py, ps = WKV.rwkv6_scan_plain(r, k, v, w, u, s0)
    assert torch.equal(y, py) and torch.equal(s, ps)
    seen, rec = calls()
    m = [like(t) for t in (r, k, v, w, u)] + [None if s0 is None
                                              else like(s0)]
    with rec():
        my, ms = WKV.rwkv6_scan(*m)
    assert sig(my) == sig(y) and sig(ms) == sig(s)
    assert seen == [("rwkv6_scan", {"BH": 6, "T": 5, "dh": 4,
                                    "with_s0": with_s0,
                                    "x_bytes": r.element_size(),
                                    "u_rows": 3})]
    # the decode cache updated in place: the state is written into s_out
    if with_s0:
        with rec():
            _, out = ops.rwkv6_scan_heads(*m, s_out=m[-1])
        assert out is m[-1]
    # the reference's (BH, T, dh) layout
    flat = [torch.empty((6, 5, 4), dtype=t.dtype, device=META)
            for t in (r, k, v, w)]
    with rec():
        fy, fs = WKV.rwkv6_scan(*flat, torch.empty((6, 4), device=META))
    assert tuple(fy.shape) == (6, 5, 4) and tuple(fs.shape) == (6, 4, 4)
    assert fy.dtype == fs.dtype == torch.float32


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_meta_gradient_matches_the_cpu_gradient(with_s0):
    T = 2 * WKV.CK + 3
    ops_cpu = wkv_operands(2, T, 3, 4, torch.float32)
    if not with_s0:
        ops_cpu = ops_cpu[:5] + (None,)
    leaves_cpu = [t.clone().requires_grad_() if t is not None else None
                  for t in ops_cpu]
    y, s = WKV.rwkv6_scan(*leaves_cpu)
    want = torch.autograd.grad((y.sum() + s.sum()),
                               [t for t in leaves_cpu if t is not None])
    leaves = [like(t).requires_grad_() if t is not None else None
              for t in ops_cpu]
    seen, rec = calls()
    with rec():
        my, ms = WKV.rwkv6_scan(*leaves)
        got = torch.autograd.grad(
            [my, ms], [t for t in leaves if t is not None],
            [torch.empty_like(my), torch.empty_like(ms)])
    assert sig(my) == sig(y) and sig(ms) == sig(s)
    assert [sig(g) for g in got] == [sig(g) for g in want]
    names = [n for n, _ in seen]
    assert names == ["rwkv6_scan", "rwkv6_scan_bwd"]
    bwd = seen[1][1]
    assert bwd["with_s0"] is with_s0 and bwd["with_ds"] is True
    assert bwd["T"] == T and bwd["BH"] == 6 and bwd["u_rows"] == 3


def test_wkv_training_keeps_the_checkpoint_buffer():
    """The SAVE forward allocates `(B, H, n_checkpoints(T), dh, dh)`; the
    meta forward keeps it for the backward as the card path does."""
    from repro_torch.roofline.component_costing import CostMode

    T = 3 * WKV.CK
    leaves = [like(t).requires_grad_() for t in
              wkv_operands(2, T, 3, 4, torch.float32)[:5]]
    with CostMode(track_memory=True, external=leaves) as mode:
        y, s = WKV.rwkv6_scan(*leaves)
        live = mode.live
    ckpt = 4 * 2 * 3 * WKV.n_checkpoints(T) * 4 * 4
    assert live == 4 * y.numel() + 4 * s.numel() + ckpt
