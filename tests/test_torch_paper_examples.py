"""The port's examples (`examples_torch/`) run on the CPU.

`quickstart.py` and `serve_fleet.py` run as scripts with `--device cpu`
(each asserts what its reference does: circuit labels equal the integer
path's, fleet and socket labels equal offline `predict`);
`evolve_approx_tnn.py` (plain NSGA-II and `--campaign`) and
`autopilot_loop.py` run in-process with the same `device="cpu"` and their
Phase-1/2 and search budgets cut, as the harness tests cut them.
"""
import importlib.util
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

EXAMPLES = H.ROOT / "examples_torch"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(*args: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=300,
        cwd=str(cwd), env={"PYTHONPATH": str(H.ROOT / "src"),
                           "PATH": "/usr/bin:/bin"})


def test_quickstart_runs_on_the_cpu(tmp_path):
    out = _script(str(EXAMPLES / "quickstart.py"), "--device", "cpu",
                  cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "matches training forward: OK" in out.stdout
    assert "(device cpu)" in out.stdout


def test_serve_fleet_runs_on_the_cpu(tmp_path):
    out = _script(str(EXAMPLES / "serve_fleet.py"), str(tmp_path / "emit"),
                  "--device", "cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "labels_match=True" in out.stdout
    assert "[serve/socket] manifest gen" in out.stdout
    assert (tmp_path / "emit" / "fleet.json").exists()


@pytest.mark.parametrize("campaign", [False, True])
def test_evolve_approx_tnn_runs_on_the_cpu(monkeypatch, tmp_path, capsys,
                                           campaign):
    mod = _load("evolve_approx_tnn")
    real_cgp, real_pcc, real_cfg = (mod.evolve_pc_library,
                                    mod.build_pcc_library, mod.NSGA2Config)
    monkeypatch.setattr(mod, "evolve_pc_library",
                        lambda n, n_points, max_iters, **kw: real_cgp(
                            n, n_points=1, max_iters=10, **kw))
    monkeypatch.setattr(mod, "build_pcc_library",
                        lambda sizes, libs, n_samples, **kw: real_pcc(
                            sizes, libs, n_samples=H.PCC_SAMPLES, **kw))
    monkeypatch.setattr(mod, "NSGA2Config",
                        lambda pop_size, n_generations, seed: real_cfg(
                            pop_size=8, n_generations=3, seed=seed))
    if campaign:
        import repro_torch.evolve as EV

        real_camp = EV.CampaignConfig
        monkeypatch.setattr(EV, "CampaignConfig",
                            lambda **kw: real_camp(**{**kw, "n_epochs": 2,
                                                      "pop_size": 8}))
    monkeypatch.chdir(tmp_path)
    mod.main("breast_cancer", campaign=campaign, islands=2,
             ckpt_dir=str(tmp_path / "ck") if campaign else None,
             device="cpu")
    out = capsys.readouterr().out
    assert "[phase3]" in out and "[compile] winner" in out
    assert "[serve]" in out and "readings/s" in out
    assert (tmp_path / "artifacts" / "tnn_breast_cancer.v").exists()


def test_autopilot_loop_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    mod = _load("autopilot_loop")
    real = mod.build_tnn_problem
    monkeypatch.setenv("REPRO_TORCH_PHASE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(mod, "build_tnn_problem",
                        lambda dataset, **kw: real(dataset, **{
                            **kw, "cgp_points": 1, "cgp_iters": 10,
                            "pcc_samples": H.PCC_SAMPLES}))
    mod.main(str(tmp_path / "fleet"), device="cpu")
    out = capsys.readouterr().out
    assert "outcomes: ['rolled_back'" in out
    assert (tmp_path / "fleet" / "autopilot_journal.jsonl").exists()
