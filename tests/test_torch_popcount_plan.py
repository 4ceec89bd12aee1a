"""The popcount kernel's routing and the plain version on word planes the
kernel routes specially.

`cuda_packed_popcount.plan` is pure Python: a thread a row (`rows`, the
block's run of rows staged transposed in shared memory) up to
`ROWS_MAX_W` words, a warp a row past it, and 16-byte loads only for a
plane that starts on a 16-byte boundary.  The plain version is held bit
for bit against `np.unpackbits` and the reference's Pallas kernel in
interpret mode on the same numpy-seeded words, on the shapes those routes
meet: every W from 0 to 64 at odd B, wider rows, and a contiguous view 4
bytes into its storage.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import cuda_packed_popcount as CP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _words(B, W, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64).astype(np.uint32)


def _unpackbits(words_u32: np.ndarray) -> np.ndarray:
    B = words_u32.shape[0]
    return np.unpackbits(words_u32.view(np.uint8).reshape(B, -1),
                         axis=1).sum(axis=1)


@pytest.mark.parametrize("W", [0, 1, 9, 32, 64, 65, 1000])
def test_plan_routes_by_width(W):
    assert CP.plan(65536, W, 0).design == ("rows" if W <= CP.ROWS_MAX_W
                                           else "warp")


@pytest.mark.parametrize("offset", [0, 4, 8, 12, 16])
def test_plan_takes_16_byte_loads_only_on_a_16_byte_boundary(offset):
    assert CP.plan(333, 9, 4096 + offset).vec16 == (offset % 16 == 0)
    assert CP.plan(333, 70, 4096 + offset).vec16 == (offset % 16 == 0)


@pytest.mark.parametrize("W", list(range(0, 65, 7)) + [64, 65, 100])
def test_plain_matches_unpackbits_at_odd_B(W):
    words = _words(333, W, W)
    got = ops.packed_popcount(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), _unpackbits(words))


@pytest.mark.parametrize("B,W", [(256, 9), (512, 70)])
def test_plane_4_bytes_into_its_storage(B, W):
    """A contiguous view at a 4-byte offset (what the kernel must load
    word by word) counts what the same words count on their own, and
    what the Pallas kernel counts in interpret mode."""
    flat = _words(1, B * W + 1, B)[0]
    view = torch.from_numpy(flat.view(np.int32))[1:].view(B, W)
    assert view.is_contiguous() and view.storage_offset() == 1
    got = ops.packed_popcount(view)
    want = rops.packed_popcount(jnp.asarray(flat[1:].reshape(B, W)),
                                use_kernel=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  _unpackbits(flat[1:].reshape(B, W)))
