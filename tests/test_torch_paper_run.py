"""`python -m benchmarks_torch.run`, the port's CSV runner.

It mirrors `benchmarks/run.py`: the same bench names, `roofline` reading
the port's dry-run records (`reports/dryrun_torch.jsonl`, relative to the
working directory, as the reference reads its own),
`name,us_per_call,derived` rows, an error row for a group that raises and
a non-zero exit at the end.
"""
import json

import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks import run as R  # noqa: E402
from benchmarks_torch import run as P  # noqa: E402


def test_bench_names_mirror_reference():
    assert P.BENCHES == R.BENCHES
    for name, mod in P.BENCH_MODULES.items():
        assert mod == R.BENCH_MODULES[name].replace("benchmarks.",
                                                    "benchmarks_torch.")
        assert (H.ROOT / (mod.replace(".", "/") + ".py")).exists()


def test_roofline_reads_the_dry_run_records(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import dryrun

    monkeypatch.chdir(tmp_path)
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--device", "cpu"])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--device", "cpu"])
    assert (tmp_path / "reports" / "dryrun_torch.jsonl").exists()
    capsys.readouterr()
    P.main(["--only", "roofline", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 3
    rows = [json.loads(line.split(",", 2)[2]) for line in lines[1:]]
    assert all(line.startswith("roofline,") for line in lines[1:])
    assert [(r["shape"], r["status"]) for r in rows] == [
        ("decode_32k", "ok"), ("long_500k", "skipped")]
    assert rows[0]["dominant"] == "memory" and rows[0]["fits"] is False


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
