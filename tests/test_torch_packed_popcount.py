"""The port's packed popcount held against `repro.kernels`, bit for bit.

Words are drawn with numpy as uint32 and handed to the port as their int32
bit patterns (the port's word convention), to the reference's Pallas
kernel in interpret mode as uint32, and to `np.unpackbits` as bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_popcount as PP  # noqa: E402


def _words(B, W, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64).astype(np.uint32)


def _port(words_u32: np.ndarray) -> np.ndarray:
    got = ops.packed_popcount(torch.from_numpy(words_u32.view(np.int32)))
    assert got.dtype == torch.int32
    return got.numpy()


def _unpackbits(words_u32: np.ndarray) -> np.ndarray:
    B = words_u32.shape[0]
    return np.unpackbits(words_u32.view(np.uint8).reshape(B, -1),
                         axis=1).sum(axis=1)


@pytest.mark.parametrize("B,W", [(256, 1), (256, 8), (512, 17), (1024, 3)])
def test_matches_pallas_kernel_and_unpackbits(B, W):
    words = _words(B, W, B + W)
    got = _port(words)
    want = rops.packed_popcount(jnp.asarray(words), use_kernel=True,
                                interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _unpackbits(words))


@pytest.mark.parametrize("B,W", [(1, 1), (1000, 3), (300, 33), (5, 0)])
def test_any_row_count(B, W):
    """B need not be a multiple of the Pallas kernel's 256-row block."""
    words = _words(B, W, 7 * B + W)
    np.testing.assert_array_equal(_port(words), _unpackbits(words))


def test_edge_values():
    words = np.array([[0, 0xFFFFFFFF, 1, 0x80000000],
                      [0x7FFFFFFF, 0x55555555, 0xAAAAAAAA, 0xFFFF0000]],
                     dtype=np.uint32)
    assert _port(words).tolist() == [0 + 32 + 1 + 1, 31 + 16 + 16 + 16]
    want = rops.packed_popcount(jnp.asarray(words[:1]), use_kernel=True,
                                interpret=True)
    assert int(want[0]) == _port(words[:1])[0]


def test_operand_checks():
    with pytest.raises(TypeError, match="int32"):
        PP.packed_popcount(torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(B, W\)"):
        PP.packed_popcount(torch.zeros((2, 3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        PP.packed_popcount(torch.zeros((4, 3), dtype=torch.int32).T)
