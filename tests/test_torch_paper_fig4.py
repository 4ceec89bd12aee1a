"""Fig. 4 through the port's harness against the reference's, on the CPU.

CGP popcount libraries (cut to `torch_paper_harness.CGP_POINTS` tau
points x `CGP_ITERS` generations in both harnesses) and the truncation
sweep: every row equal, floats with `==`.
"""
import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks import fig4_pc_pareto as R  # noqa: E402
from benchmarks_torch import fig4_pc_pareto as P  # noqa: E402


@pytest.mark.parametrize("sizes", [[8], [16], [5, 11]])
def test_fig4_rows_equal_reference(monkeypatch, sizes):
    H.shrink_libraries(monkeypatch)
    ref = R.run(sizes)
    got = P.run(sizes, device="cpu")
    assert got == ref
    assert {r["method"] for r in got} >= {"cgp", "trunc1"}


def test_pc_library_cache_is_keyed_by_device(monkeypatch):
    H.shrink_libraries(monkeypatch)
    lib = H.PCOM.get_pc_library(6, points=1, iters=5, device="cpu")
    assert H.PCOM.get_pc_library(6, points=1, iters=5, device="cpu") is lib
    assert list(H.PCOM._PC_CACHE) == [("cpu", 6, 1, 5, 0)]
    assert lib[0].meta["metric"] == "exact"
