"""`python -m benchmarks_torch.run`, the port's CSV runner.

It mirrors `benchmarks/run.py`: the same bench names but `roofline`
(which waits for the port's LM dry-run launcher and exits 2 naming
ROADMAP Queue 1 item 4), `name,us_per_call,derived` rows, an error row for
a group that raises and a non-zero exit at the end.
"""
import json

import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks import run as R  # noqa: E402
from benchmarks_torch import run as P  # noqa: E402


def test_bench_names_mirror_reference_but_roofline():
    assert P.BENCHES == [b for b in R.BENCHES if b != "roofline"]
    for name, mod in P.BENCH_MODULES.items():
        assert mod == R.BENCH_MODULES[name].replace("benchmarks.",
                                                    "benchmarks_torch.")
        assert (H.ROOT / (mod.replace(".", "/") + ".py")).exists()


def test_roofline_exits_2_naming_the_roadmap(capsys):
    with pytest.raises(SystemExit) as exc:
        P.main(["--only", "table2,roofline", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr()
    assert "Queue 1 item 4" in err.err and err.out == ""


def test_unknown_bench_is_refused():
    with pytest.raises(SystemExit, match="unknown bench name"):
        P.main(["--only", "fig9", "--device", "cpu"])


def test_a_failing_group_prints_an_error_row_and_fails(monkeypatch, capsys):
    class Boom:
        @staticmethod
        def run(device=None):
            raise RuntimeError("boom on " + str(device))

    class Fine:
        @staticmethod
        def run(device=None):
            return [{"bench": "fig6", "device": str(device)}]

    monkeypatch.setattr(P, "_load",
                        lambda name: Boom if name == "fig5" else Fine)
    with pytest.raises(SystemExit, match="1 benchmark groups failed"):
        P.main(["--only", "fig5,fig6", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    name, _, payload = lines[1].split(",", 2)
    assert name == "fig5" and json.loads(payload) == {"error": "boom on cpu"}
    name, _, payload = lines[2].split(",", 2)
    assert name == "fig6" and json.loads(payload) == {"device": "cpu"}


def test_quick_budgets_follow_the_reference(monkeypatch):
    assert H.PCOM.QUICK == H.RCOM.QUICK
    import importlib

    monkeypatch.setenv("REPRO_BENCH_FULL", "1")
    full = importlib.reload(H.PCOM)
    try:
        assert full.QUICK is False
    finally:
        monkeypatch.delenv("REPRO_BENCH_FULL")
        importlib.reload(H.PCOM)
