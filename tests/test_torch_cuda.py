"""The CUDA gate-walk kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests skip where
`torch.cuda.is_available()` is false.  On a machine with a GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compile.artifact import load_manifest, load_program  # noqa: E402
from repro_torch.kernels import circuit_sim as CS  # noqa: E402
from repro_torch.kernels import cuda_circuit_sim as CK  # noqa: E402

pytestmark = pytest.mark.cuda

TESTS = Path(__file__).parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _population(rng, n_in, G, n_out, P):
    hi = n_in + np.arange(G)
    op = rng.integers(1, 13, size=(P, G))
    in0 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    in1 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    outputs = rng.integers(0, n_in + G, size=(P, n_out))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (op, in0, in1, outputs)]


@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("n_in,G,n_out,P,W", [
    (6, 40, 3, 5, 1), (12, 300, 5, 3, 33), (274, 3020, 4, 1, 130),
    (5, 0, 2, 3, 33), (4, 10, 2, 3, 0)])
def test_kernels_equal_plain(cuda, n_in, G, n_out, P, W, per_individual):
    rng = np.random.default_rng(n_in * 1000 + G + W)
    plan = [torch.from_numpy(a).to(cuda)
            for a in _population(rng, n_in, G, n_out, P)]
    shape = (P, n_in, W) if per_individual else (n_in, W)
    words = torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(cuda)
    torch.testing.assert_close(
        CK.fused_eval_uint(*plan, words, n_in),
        CS.population_eval_uint(*plan, words, n_in), rtol=0, atol=0)
    torch.testing.assert_close(
        CK.simulate_population(*plan, words, n_in),
        CS.simulate_population(*plan, words, n_in), rtol=0, atol=0)


def test_golden_bundles_serve_through_the_kernel(cuda):
    CK.reset_launches()
    rows = load_manifest(TESTS / "golden_emit")
    for row in rows:
        prog = load_program(TESTS / "golden_emit" / row["program"],
                            device=cuda, expect_sha256=row["sha256"])
        fix = np.load(TESTS / "golden" / f"{row['name']}.npz")
        np.testing.assert_array_equal(prog.predict(fix["x"]), fix["labels"])
    assert CK.LAUNCHES["fused_eval_uint"] == len(rows)
