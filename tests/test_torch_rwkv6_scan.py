"""The port's WKV-6 recurrence held against `repro.kernels`.

The same numpy-seeded float32 operands go through the port's
`ops.rwkv6_scan` (the plain version on the CPU) and the reference's
sequential oracle `ref.rwkv6_scan_ref`, at decays drawn from U(0.01, 0.999)
— real RWKV-6 decays `exp(-exp(.))` reach far below the w >~ 0.6 that the
reference's chunked Pallas kernel is limited to.  On that kernel's own
domain (w >= 0.85, `tests/test_rwkv6_kernel.py`'s shapes) the port is also
held against the kernel in interpret mode.

Tolerances: against the oracle `rtol = atol = 1e-4`.  Both run the same
recurrence in float32 in the same token order and differ only in the
order of the sum over the key dimension (~1e-6 relative at |y| <= 100 over
256 tokens); a wrong formula moves values by O(1).  Against the chunked
kernel, 2e-3, the tolerance the reference's own test holds that kernel to.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as WKV  # noqa: E402

TOL = 1e-4
KERNEL_TOL = 2e-3


def _inputs(seed, BH, T, dh, w_lo=0.01, w_hi=0.999):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (BH, T, dh)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (BH, T, dh)).astype(np.float32)
    u = rng.normal(0, 0.5, (BH, dh)).astype(np.float32)
    return r, k, v, w, u


def _port(*arrays, **kw):
    return ops.rwkv6_scan(*(torch.from_numpy(a) for a in arrays), **kw)


@pytest.mark.parametrize("BH,T,dh", [(1, 1, 16), (2, 7, 16), (3, 64, 64),
                                     (2, 256, 16), (1, 256, 64)])
def test_plain_matches_sequential_oracle(BH, T, dh):
    args = _inputs(BH * 1000 + T + dh, BH, T, dh)
    y, s = _port(*args)
    y_r, s_r = ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in args))
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (BH, T, dh) and tuple(s.shape) == (BH, dh, dh)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("BH,T,dh,chunk", [(2, 64, 16, 16), (4, 128, 32, 32),
                                           (1, 96, 8, 32), (3, 64, 64, 64)])
def test_plain_matches_chunked_kernel_on_its_domain(BH, T, dh, chunk):
    args = _inputs(7 + T, BH, T, dh, w_lo=0.85)
    y, s = _port(*args, chunk=chunk)
    y_k, s_k = rops.rwkv6_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                               use_kernel=True, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("split", [1, 5, 31])
def test_state_carried_across_a_split_equals_one_pass(split):
    """Two calls, the second starting from the first's final state, give
    what one call over the whole sequence gives, bit for bit: the plain
    version runs the same float32 operations in the same order."""
    r, k, v, w, u = _inputs(split, 3, 32, 16)
    y, s = _port(r, k, v, w, u)
    y1, s1 = _port(r[:, :split], k[:, :split], v[:, :split], w[:, :split], u)
    y2, s2 = _port(r[:, split:], k[:, split:], v[:, split:], w[:, split:], u,
                   s0=s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(s2, s)


def test_one_token_from_a_state_matches_the_formula():
    """T = 1 (a decode step) from a given state, against the recurrence
    written out in float64."""
    r, k, v, w, u = _inputs(3, 2, 1, 16)
    s0 = np.random.default_rng(4).normal(0, 1, (2, 16, 16)).astype(np.float32)
    y, s = _port(r, k, v, w, u, s0=torch.from_numpy(s0))
    r64, k64, v64, w64 = (a[:, 0].astype(np.float64) for a in (r, k, v, w))
    kv = k64[:, :, None] * v64[:, None, :]
    want_y = np.einsum("bk,bkv->bv", r64, s0 + u[:, :, None] * kv)
    want_s = w64[:, :, None] * s0 + kv
    np.testing.assert_allclose(y[:, 0].numpy(), want_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=TOL, atol=TOL)


def test_chunk_does_not_change_the_result():
    args = _inputs(5, 2, 40, 16)
    y, s = _port(*args)
    for chunk in (1, 7, 32, 64):
        y_c, s_c = _port(*args, chunk=chunk)
        assert torch.equal(y_c, y) and torch.equal(s_c, s)
    with pytest.raises(ValueError, match="chunk"):
        _port(*args, chunk=0)


def test_decay_actually_decays():
    """With strong decay and zero u, late outputs forget early tokens."""
    BH, T, dh = 1, 32, 8
    r = torch.ones((BH, T, dh))
    k = torch.zeros((BH, T, dh))
    k[:, 0] = 1.0
    v = torch.ones((BH, T, dh))
    w = torch.full((BH, T, dh), 0.01)
    y, _ = ops.rwkv6_scan(r, k, v, w, torch.zeros((BH, dh)))
    mag = y[0, :, 0].abs()
    assert mag[1] > mag[2] > mag[3] > 0


def test_operand_checks():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(6, 2, 4, 16))
    with pytest.raises(TypeError, match="float32"):
        WKV.rwkv6_scan(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="w is"):
        WKV.rwkv6_scan(r, k, v, w[:, :3].contiguous(), u)
    with pytest.raises(ValueError, match="u must be"):
        WKV.rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        WKV.rwkv6_scan(r, k, v, w, u, torch.zeros((2, 16, 8)))
    # strided rows and tokens are taken; the last dimension must be
    # contiguous and heads dh apart
    with pytest.raises(ValueError, match="contiguous"):
        WKV.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k,
                       v, w, u)
    with pytest.raises(TypeError, match="like r"):
        WKV.rwkv6_scan(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError, match="float32"):
        WKV.rwkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(),
                       w.bfloat16(), u)
    r4, k4, v4, w4 = (a.reshape(1, 2, 4, 16).transpose(1, 2)
                      for a in (r, k, v, w))              # heads 64 apart
    with pytest.raises(ValueError, match="heads"):
        WKV.rwkv6_scan(r4, k4, v4, w4, u)
    with pytest.raises(ValueError, match="s_out must be contiguous"):
        WKV.rwkv6_scan(r, k, v, w, u, None,
                       torch.zeros((2, 16, 16)).transpose(1, 2))
