"""Figs. 5 and 6 through the port's harness against the reference's.

From the same golden TNNs and the same cut budgets in both harnesses
(`torch_paper_harness`), the PCC Pareto fronts, the distance histogram
and the estimated-against-synthesized areas: every row equal, floats with
`==`, on the CPU.
"""
import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks import fig5_pcc_pareto as R5  # noqa: E402
from benchmarks import fig6_area_estimate as R6  # noqa: E402
from benchmarks_torch import fig5_pcc_pareto as P5  # noqa: E402
from benchmarks_torch import fig6_area_estimate as P6  # noqa: E402


@pytest.mark.parametrize("name", ["cardio", "breast_cancer", "redwine"])
def test_fig5_rows_equal_reference(monkeypatch, name):
    H.seed_tnn_caches(monkeypatch, [name])
    H.shrink_libraries(monkeypatch)
    ref = R5.run(name)
    got = P5.run(name, device="cpu")
    assert got == ref
    assert any(r["bench"] == "fig5" for r in got)


@pytest.mark.parametrize("name", ["cardio", "whitewine"])
def test_fig6_rows_equal_reference(monkeypatch, name):
    H.seed_tnn_caches(monkeypatch, [name])
    H.shrink_libraries(monkeypatch)
    ref = R6.run(name)
    got = P6.run(name, device="cpu")
    assert got == ref
    assert got[-1]["bench"] == "fig6_summary"
    assert got[-1]["n_points"] == len(got) - 1
