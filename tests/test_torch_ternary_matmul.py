"""The port's ternary matmul held against the reference's Pallas kernel.

`repro_torch.kernels.ternary_matmul` on CPU tensors runs the plain
PyTorch version; it is compared with the reference Pallas kernel in
interpret mode (`ops.ternary_matmul(..., use_kernel=True, interpret=True)`)
and with `ref.ternary_matmul_ref`.  Packed bytes are drawn from all 256
values, so code 0b11 occurs.

Tolerances.  f32: every result lies inside the f32 dot-product envelope
around the float64 product, `eps * sqrt(K) * (|x| @ |w|) * |scale| + 1e-6`
(tests/test_kernels.py), because the three sum in different orders.
bf16: `rtol = atol = 2e-2` between the port and the interpret-mode
kernel, as tests/test_kernels.py holds the kernel against its reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.core.ternary import unpack_ternary  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_matmul as TM  # noqa: E402

SHAPES = [(128, 512, 128), (256, 512, 256), (128, 1024, 384),
          (384, 2048, 128), (1, 512, 128), (7, 512, 128)]


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w2 = rng.integers(-128, 128, (K // 4, N)).astype(np.int8)
    scale = np.abs(rng.normal(1, 0.1, (1, N))).astype(np.float32)
    return x, w2, scale


def _envelope(x, w2, scale):
    x64 = np.asarray(x, np.float64)
    w64 = unpack_ternary(torch.from_numpy(w2), torch.float64).numpy()
    s64 = np.asarray(scale, np.float64)
    exact = (x64 @ w64) * s64
    K = x64.shape[1]
    bound = (np.finfo(np.float32).eps * np.sqrt(K)
             * (np.abs(x64) @ np.abs(w64)) * np.abs(s64) + 1e-6)
    return exact, bound


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_f32_matches_pallas_and_ref(M, K, N):
    x, w2, scale = _operands(M, K, N, M * K + N)
    got = TM.ternary_matmul(torch.from_numpy(x), torch.from_numpy(w2),
                            torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    pallas = np.asarray(ROPS.ternary_matmul(
        jnp.asarray(x), jnp.asarray(w2), jnp.asarray(scale),
        use_kernel=True, interpret=True))
    want = np.asarray(RREF.ternary_matmul_ref(
        jnp.asarray(x), jnp.asarray(w2), jnp.asarray(scale)))
    exact, bound = _envelope(x, w2, scale)
    for name, y in (("port", got.numpy()), ("pallas", pallas),
                    ("ref", want)):
        err = np.abs(np.asarray(y, np.float64) - exact)
        assert (err <= bound).all(), f"{name}: max err/bound " \
            f"{(err / bound).max():.3f}"


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_bf16_matches_pallas(M, K, N):
    x, w2, scale = _operands(M, K, N, M + K * N)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = TM.ternary_matmul(xt, torch.from_numpy(w2),
                            torch.from_numpy(scale))
    xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)   # same bf16 values
    pallas = np.asarray(ROPS.ternary_matmul(
        xj, jnp.asarray(w2), jnp.asarray(scale), use_kernel=True,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-2, atol=2e-2)


def test_ops_takes_any_leading_shape():
    B, S, K, N = 2, 3, 64, 24
    x, w2, scale = _operands(B * S, K, N, 7)
    x3 = torch.from_numpy(x).reshape(B, S, K)
    got = ops.ternary_matmul(x3, torch.from_numpy(w2),
                             torch.from_numpy(scale))
    assert got.shape == (B, S, N) and got.dtype == torch.float32
    want = TM.ternary_matmul_plain(torch.from_numpy(x), torch.from_numpy(w2),
                                   torch.from_numpy(scale))
    torch.testing.assert_close(got.reshape(B * S, N), want, rtol=0, atol=0)
    ref = np.asarray(RREF.ternary_matmul_ref(
        jnp.asarray(x), jnp.asarray(w2), jnp.asarray(scale)))
    exact, bound = _envelope(x, w2, scale)
    assert (np.abs(got.reshape(B * S, N).numpy() - exact) <= bound).all()
    assert (np.abs(ref - exact) <= bound).all()


@pytest.mark.parametrize("bad,match", [
    (dict(x=torch.zeros(2, 8, dtype=torch.float16)), "float32 or bfloat16"),
    (dict(w2=torch.zeros(2, 4, dtype=torch.uint8)), "int8"),
    (dict(scale=torch.ones(1, 4, dtype=torch.float64)), "float32"),
    (dict(w2=torch.zeros(3, 4, dtype=torch.int8)), "packed rows"),
    (dict(x=torch.zeros(2, 6)), "packed rows"),
    (dict(scale=torch.ones(4)), r"\(1, 4\)"),
    (dict(x=torch.zeros(8, 2).T), "contiguous"),
])
def test_wrapper_rejects_bad_operands(bad, match):
    args = dict(x=torch.zeros(2, 8), w2=torch.zeros(2, 4, dtype=torch.int8),
                scale=torch.ones(1, 4))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        TM.ternary_matmul(args["x"], args["w2"], args["scale"])
