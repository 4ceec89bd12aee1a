"""Figs. 7 and 8 and Table 3 through the port's harness against the
reference's, on the CPU.

From the same golden TNNs, the same cut Phase-1/2 budgets and NSGA-II cut
to `torch_paper_harness.NSGA_POP` x `NSGA_GENERATIONS` in both harnesses:
the fronts, their test accuracies, areas and powers, the headline savings,
the convergence history and Table 3 with and without the interface are
equal, floats with `==`.  Table 3's MLP baselines are the golden integer
weights in both (their QAT is held to its tolerance by
`test_torch_paper_table2.py`).
"""
import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks import fig7_tnn_pareto as R7  # noqa: E402
from benchmarks import fig8_nsga2 as R8  # noqa: E402
from benchmarks import table3_sota as R3  # noqa: E402
from benchmarks_torch import fig7_tnn_pareto as P7  # noqa: E402
from benchmarks_torch import fig8_nsga2 as P8  # noqa: E402
from benchmarks_torch import table3_sota as P3  # noqa: E402


@pytest.mark.parametrize("names", [["cardio"], ["breast_cancer", "redwine"]])
def test_fig7_rows_equal_reference(monkeypatch, names):
    H.seed_tnn_caches(monkeypatch, names)
    H.shrink_libraries(monkeypatch)
    H.shrink_nsga(monkeypatch, R7, P7)
    ref = R7.run(names)
    got = P7.run(names, device="cpu")
    assert got == ref
    assert got[-1]["bench"] == "fig7_headline"
    assert sum(r["bench"] == "fig7_summary" for r in got) == len(names)


@pytest.mark.parametrize("name", ["cardio", "whitewine"])
def test_fig8_rows_equal_reference(monkeypatch, name):
    H.seed_tnn_caches(monkeypatch, [name])
    H.shrink_libraries(monkeypatch)
    H.shrink_nsga(monkeypatch, R8, P8)
    ref = R8.run(name)
    got = P8.run(name, device="cpu")
    assert got == ref
    assert got[-1]["bench"] == "fig8_summary"


@pytest.mark.parametrize("name", ["cardio", "redwine"])
def test_table3_rows_equal_reference(monkeypatch, name):
    H.seed_tnn_caches(monkeypatch, [name])
    H.shrink_libraries(monkeypatch)
    H.shrink_nsga(monkeypatch, R3, P3)
    H.golden_mlps(monkeypatch, R3, P3)
    ref = R3.run([name])
    got = P3.run([name], device="cpu")
    assert got == ref
    designs = [r["design"] for r in got if r["bench"] == "table3"]
    assert designs[:3] == ["exact_mlp[37]", "ax_mlp_pow2[1,2]",
                           "our_exact_tnn"]
