"""The port's LM ternary codes held against `repro.core.ternary`.

Packing and unpacking must be bit-identical to the reference (every byte
value, so code 0b11 is covered); `ternary_quantize_lm` must give the same
codes, and an alpha within 4 ulp of the reference's.  The alpha tolerance
is the reduction order: both take an f32 mean over K, XLA and PyTorch sum
in different orders, and on these inputs the two land up to 3 ulp apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ternary as R  # noqa: E402
from repro_torch.core import ternary as T  # noqa: E402


@pytest.mark.parametrize("K,N", [(4, 1), (16, 5), (64, 32), (36, 130)])
def test_pack_matches_reference(K, N):
    rng = np.random.default_rng(K * 100 + N)
    codes = rng.integers(-1, 2, (K, N)).astype(np.int8)
    want = np.asarray(R.pack_ternary(jnp.asarray(codes)))
    got = T.pack_ternary(torch.from_numpy(codes))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        T.unpack_ternary(got).numpy().astype(np.int8), codes)


def test_unpack_every_byte_matches_reference():
    """All 256 byte values, including every placement of code 0b11 (-> 0)."""
    by = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(64, 4)
    want = np.asarray(R.unpack_ternary(jnp.asarray(by)))
    got = T.unpack_ternary(torch.from_numpy(by))
    np.testing.assert_array_equal(got.numpy(), want)
    assert T.unpack_ternary(torch.tensor([[-1]], dtype=torch.int8)).abs() \
        .sum() == 0     # 0xFF: four 0b11 codes


def test_pack_rejects_ragged_k():
    with pytest.raises(ValueError, match="multiple of 4"):
        T.pack_ternary(torch.zeros((6, 2)))


@pytest.mark.parametrize("K,N", [(64, 32), (2048, 64), (128, 128)])
def test_quantize_lm_matches_reference(K, N):
    rng = np.random.default_rng(K + N)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    codes_r, alpha_r = (np.asarray(a) for a in
                        R.ternary_quantize_lm(jnp.asarray(w)))
    codes, alpha = T.ternary_quantize_lm(torch.from_numpy(w))
    np.testing.assert_array_equal(codes.numpy(), codes_r)
    assert alpha.shape == (1, N)
    ulps = np.abs(alpha.numpy() - alpha_r) / np.spacing(alpha_r)
    assert ulps.max() <= 4
    assert float(T.zero_fraction(codes)) == pytest.approx(
        float(R.zero_fraction(jnp.asarray(codes_r))), abs=0)
