"""The port stands alone: no JAX, nothing of `repro`, no silent CPU.

* Importing `repro_torch`, serving a committed bundle, running one
  reduced LM decode step, serving a reduced RWKV-6 model, serving each
  row of `launch/families.py` (the rows `chip_smoke.py`'s `lm_families`
  phase serves) reduced (MoE through `models/moe.py`, the Mamba hybrid,
  whisper, Qwen2-VL, the Qwen archs, an fp8 KV cache; weights from
  `serving_params`), importing `chip_smoke.py` itself, and a packed
  popcount load neither `jax` nor
  any `repro` module (checked in a fresh interpreter); nor do the
  campaign modules (CGP, PCC, NSGA-II, the TNN
  problem, the datasets) running a tiny cardio search; nor does the
  pipeline (QAT, the optimizer, lowering, the Verilog writer and reader,
  the bundle writer and the export CLI) training and emitting a cardio
  classifier; nor does the fleet stack (`repro_torch.serve`: a CPU fleet
  over the golden manifest, the MLP baselines, `python -m
  repro_torch.serve --help`); nor does the campaign layer
  (`repro_torch.checkpoint`, `evolve`, `compile.zoo`, `autopilot`: a
  checkpointed TNN campaign resumed, a zoo entry built, an autopilot
  round journaled), which loads neither `msgpack` nor `ml_dtypes`; nor
  does the port's harness (`python -m benchmarks_torch.run --only fig4
  --device cpu` at a cut budget), which loads no `benchmarks` module
  either.
* No source of the port, nor of its harness (`benchmarks_torch/`) and
  examples (`examples_torch/`), nor `chip_smoke.py`, imports JAX,
  `repro`, the reference's `benchmarks`, `msgpack` or `ml_dtypes`, or
  calls `torch.compile`.
* An entry point called without `device` on a machine without CUDA raises
  instead of running on the CPU; so does `python -m benchmarks_torch.run`
  without `--device`.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.compile import artifact as A  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.models.params import init_params, serving_params  # noqa: E402,E501
from repro_torch.serve.lm_engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EMIT_DIR = ROOT / "tests" / "golden_emit"

FORBIDDEN = [
    (re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)", re.M), "imports jax"),
    (re.compile(r"^\s*from\s+repro(\.|\s)", re.M), "imports from repro"),
    (re.compile(r"^\s*import\s+repro(\.|\s|,|$)", re.M), "imports repro"),
    (re.compile(r"(?<![\w.])torch\.compile\b"), "calls torch.compile"),
    (re.compile(r"^\s*(import|from)\s+(msgpack|ml_dtypes)(\.|\s|$)", re.M),
     "imports msgpack or ml_dtypes"),
    (re.compile(r"^\s*(import|from)\s+benchmarks(\.|\s|,|$)", re.M),
     "imports the reference's benchmarks"),
]
HARNESS = [ROOT / "benchmarks_torch", ROOT / "examples_torch"]


def test_serving_loads_neither_jax_nor_repro():
    script = f"""
import json, sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
from repro_torch.compile.artifact import load_program
from repro_torch.serve.engine import CircuitServingEngine
fix = np.load({str(ROOT / 'tests' / 'golden' / 'cardio.npz')!r})
prog = load_program({str(EMIT_DIR / 'cardio_program.npz')!r}, device="cpu")
ok = bool((prog.predict(fix["x"]) == fix["labels"]).all())
ok &= bool((CircuitServingEngine(prog, 64).classify_stream(fix["x"])
            == fix["labels"]).all())
import torch
import repro_torch.launch.serve
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as TF
from repro_torch.models.params import serving_params
from repro_torch.serve.lm_engine import Request, ServingEngine
cfg = get_config("llama3.2-1b").reduced().replace(quant="ternary_packed")
params = serving_params(cfg, 0, "cpu")
cache = TF.init_cache(cfg, 1, 8, device="cpu")
logits, _ = TF.decode_step(cfg, params, cache, torch.tensor([[3]]), 0)
ok &= bool(torch.isfinite(logits).all())
ok &= len(ServingEngine(cfg, params, 1, 8, device="cpu").run(
    [Request(0, [1, 2], 2)])[0].output) == 2
from repro_torch.models.params import init_params
rcfg = get_config("rwkv6-7b").reduced()
ok &= len(ServingEngine(rcfg, init_params(rcfg, 0, "cpu"), 1, 8,
                        device="cpu").run([Request(0, [1, 2], 2)])[0]
          .output) == 2
words = torch.tensor([[1, -1]], dtype=torch.int32)
ok &= ops.packed_popcount(words).tolist() == [33]
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke
import repro_torch.models.moe
from repro_torch.configs import ARCHS
from repro_torch.launch.families import FAMILIES
served = set()
for fam in FAMILIES:
    small = get_config(fam.arch).reduced().replace(quant=fam.quant,
                                                   **dict(fam.over))
    ok &= fam.config().d_model == get_config(fam.arch).d_model
    eng = ServingEngine(small, serving_params(small, 0, "cpu"), 2, 16,
                        device="cpu")
    ok &= len(eng.run([Request(0, list(range(1, 9)), 2)])[0].output) == 2
    ok &= sum(chip_smoke.family_launches(small, 1, 1).values()) >= 0
    served.add(fam.arch)
ok &= served == set(ARCHS) - {{"rwkv6-7b"}}
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"ok": ok, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted(p for d in HARNESS for p in d.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_stand_alone(path):
    text = path.read_text()
    for pattern, what in FORBIDDEN:
        m = pattern.search(text)
        assert m is None, f"{path.name} {what}: {m.group(0).strip()!r}"


def test_campaign_loads_neither_jax_nor_repro():
    script = f"""
import json, sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
from repro_torch.configs.tnn_paper import get_tnn_config
from repro_torch.core import cgp, circuits as C, pcc, tnn as T
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.ternary import abc_binarize
from repro_torch.data.tabular import make_dataset
from repro_torch.hw.egfet import power_source
tnn = T.load_tnn({str(EMIT_DIR / 'cardio_tnn.npz')!r})
ds = make_dataset("cardio")
sizes = sorted({{(p, n) for p, n in tnn.hidden_sizes() if p and n}})
libs = {{n: cgp.evolve_pc_library(n, n_points=1, max_iters=3, n_nodes=40,
                                  parallel=False, device="cpu")
        for n in sorted({{k for s in sizes for k in s}} | {{tnn.out_nnz}})}}
lib = pcc.build_pcc_library(sizes, libs, n_samples=500, device="cpu")
prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=lib,
                          pc_out_lib=pcc.pc_pareto(libs[tnn.out_nnz]),
                          xbin=abc_binarize(ds.x_train, tnn.thresholds,
                                            device="cpu"),
                          y=ds.y_train, device="cpu")
res = prob.optimize(NSGA2Config(pop_size=8, n_generations=2, seed=0))
cost = T.tnn_hw_cost(tnn, *prob.decode(res.pareto_x[0]))
ok = bool(len(res.pareto_x)) and cost.area_mm2 > 0
ok &= get_tnn_config("cardio").nsga_pop == 32 and bool(power_source(1.0))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"ok": ok, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


def test_pipeline_loads_neither_jax_nor_repro(tmp_path):
    script = f"""
import json, sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
from repro_torch.compile import (CircuitProgram, eval_classifier_verilog,
                                 load_manifest, load_program,
                                 lower_classifier, write_artifacts)
from repro_torch.compile import export
from repro_torch.core import tnn as T
from repro_torch.data.tabular import make_dataset
from repro_torch.optim import adamw
ds = make_dataset("cardio")
tnn = T.train_tnn(ds, T.TNNTrainConfig(n_hidden=3, epochs=1, lr=1e-2),
                  device="cpu")
cc = lower_classifier(tnn, *T.exact_netlists(tnn))
paths = write_artifacts(cc, {str(tmp_path)!r}, base="cardio")
row = load_manifest({str(tmp_path)!r})[0]
prog = load_program({str(tmp_path)!r} + "/" + row["program"], device="cpu",
                    expect_sha256=row["sha256"])
xb = prog.binarize(ds.x_test).numpy()
ok = bool((eval_classifier_verilog(open(paths["verilog"]).read(), xb)
           == prog.predict(ds.x_test)).all())
ok &= bool((prog.predict(ds.x_test) == T.predict_exact(tnn, xb)).all())
ok &= callable(export.main) and adamw.AdamWConfig().grad_clip == 1.0
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"ok": ok, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


def test_fleet_loads_neither_jax_nor_repro():
    script = f"""
import json, subprocess, sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
import repro_torch.serve
from repro_torch.core.baselines import mlp_hw_cost
from repro_torch.serve import ClassifierFleet
from repro_torch.serve.server import FleetServer
from repro_torch.serve.client import FleetClient
fix = np.load({str(ROOT / 'tests' / 'golden' / 'cardio.npz')!r})
fleet = ClassifierFleet.from_emit_dir({str(EMIT_DIR)!r}, device="cpu",
                                      tenants=["cardio"], deadline_ms=50.0)
server = FleetServer(fleet)
host, port = server.start_background()
with FleetClient(host, port) as client:
    ok = bool((client.classify("cardio", fix["x"], timeout=60.0)
               == fix["labels"]).all())
server.stop()
fleet.shutdown()
ok &= mlp_hw_cost([np.ones((2, 2), np.int32)], 4, 8, False, None).area_mm2 > 0
cli = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--help"],
                     capture_output=True, text=True, timeout=120,
                     env={{"PYTHONPATH": {str(ROOT / 'src')!r}}})
ok &= cli.returncode == 0 and "replay" in cli.stdout
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"ok": ok, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=180, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


def test_campaign_layer_loads_neither_jax_nor_repro(tmp_path):
    script = f"""
import json, sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
from repro_torch.autopilot import (Autopilot, AutopilotConfig, Candidate,
                                   DecisionJournal, PromotionPolicy,
                                   ScriptedSource)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.compile import CircuitProgram, write_artifacts
from repro_torch.compile.zoo import build_zoo, make_entries
from repro_torch.evolve import (Campaign, CampaignConfig, ProblemSpec,
                                compile_archive_winner)
from repro_torch.serve import ClassifierFleet
root = {str(tmp_path)!r}
budget = dict(seed=0, epochs=1, cgp_points=1, cgp_iters=5, pcc_samples=200)
spec = ProblemSpec("tnn", dict(dataset="cardio", device="cpu",
                               cache_dir=root + "/cache", **budget))
p = spec.build()
cfg = CampaignConfig(n_islands=2, pop_size=6, n_epochs=2, gens_per_epoch=1,
                     device="cpu")
full = Campaign(p.domains, p.objective, cfg,
                seed_population=p.seed_population).run()
import dataclasses
Campaign(p.domains, p.objective, dataclasses.replace(cfg, n_epochs=1),
         checkpoint_dir=root + "/ck",
         seed_population=p.seed_population).run()
res = Campaign(p.domains, p.objective, cfg, checkpoint_dir=root + "/ck",
               seed_population=p.seed_population).run()
ok = res.resumed_from == 0
cc = compile_archive_winner(p, full.archive_x[0])
write_artifacts(cc, root + "/fleet", base="tnn_cardio", dataset="cardio")
rep = build_zoo(make_entries(["cardio"], ["base"], islands=2, pop=6,
                             epochs=1, gens_per_epoch=1, tnn_epochs=1,
                             cgp_points=1, cgp_iters=5, pcc_samples=200,
                             device="cpu"),
                root + "/zoo", cache_dir=root + "/cache")
ok &= rep["built"] == ["tnn_cardio__base"]
fleet = ClassifierFleet.from_emit_dir(root + "/fleet", device="cpu")
prog = CircuitProgram.from_classifier(cc, device="cpu")
def traffic():
    rng = np.random.default_rng(0)
    while True:
        x = rng.random((16, cc.n_features))
        yield x, prog.predict(x)
pilot = Autopilot(fleet, ScriptedSource([Candidate(cc, [0.0, 1.0], {{}})]),
                  traffic(), DecisionJournal(root + "/j.jsonl"),
                  AutopilotConfig(tenant="tnn_cardio", mirror_pairs=32,
                                  policy=PromotionPolicy(min_pairs=16)))
ok &= [o["event"] for o in pilot.run()] == ["promoted"]
fleet.shutdown()
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "msgpack", "ml_dtypes")
             or m.startswith(("jax.", "repro.", "msgpack.", "ml_dtypes.")))
print(json.dumps({{"ok": bool(ok), "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=180, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


def test_campaign_entry_points_without_device_need_cuda(monkeypatch,
                                                        tmp_path):
    from repro_torch.autopilot import __main__ as autopilot_cli
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.compile.zoo import build_zoo, make_entries
    from repro_torch.evolve import IslandExecutor, ProblemSpec
    from repro_torch.evolve import build_tnn_problem
    from repro_torch.evolve import __main__ as evolve_cli
    from repro_torch.evolve.config import CampaignConfig

    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(0, {"x": np.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm.restore({"x": np.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tnn_problem("cardio", cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IslandExecutor(ProblemSpec("tnn", {"dataset": "cardio"}),
                       CampaignConfig(workers=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_zoo(make_entries(["cardio"], ["base"]), tmp_path / "zoo",
                  workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evolve_cli.main(["--dataset", "cardio", "--phase-cache",
                         str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autopilot_cli.main(["run", "--emit-dir", str(EMIT_DIR),
                            "--tenant", "cardio", "--dataset", "cardio",
                            "--phase-cache", str(tmp_path)])


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.load_program(EMIT_DIR / "cardio_program.npz")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.replica_devices(0)
    cfg = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(get_config("rwkv6-7b").reduced())
    from repro_torch.core import cgp, circuits, ternary
    from repro_torch.kernels import cuda_circuit_sim as CK
    nl = circuits.popcount_netlist(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CK.schedule(nl.op[None], nl.in0[None], nl.in1[None], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cgp.evolve_popcount(cgp.CGPConfig(3, 2, 10, max_iters=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ternary.abc_binarize(np.zeros((2, 3)), np.zeros(3))
    from repro_torch.compile import export
    from repro_torch.compile.program import CircuitProgram
    from repro_torch.core import tnn
    from repro_torch.data.tabular import make_dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.train_tnn(make_dataset("cardio"), tnn.TNNTrainConfig(3, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.params_from_arrays({"w1": np.zeros((2, 1)),
                                "w2": np.zeros((1, 2))})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main("cardio", "unused", epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CircuitProgram.from_netlist(nl)
    from repro_torch.core import baselines
    from repro_torch.serve import ClassifierFleet, TenantSpec, WorkerHost
    from repro_torch.serve import __main__ as serve_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierFleet.from_emit_dir(EMIT_DIR, tenants=["cardio"])
    prog = A.load_program(EMIT_DIR / "cardio_program.npz", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierFleet([TenantSpec(name="cardio", program=prog)],
                        warmup=False, autostart=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerHost(None, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baselines.train_mlp_baseline(make_dataset("cardio"), 3, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["replay", "--emit-dir", str(EMIT_DIR),
                        "--replay", "cardio", "--readings", "4"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_harness_loads_neither_jax_nor_repro_nor_benchmarks():
    script = f"""
import contextlib, io, json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import benchmarks_torch.common as common
real = common.evolve_pc_library
common.evolve_pc_library = lambda n, n_points, max_iters, seed, **kw: real(
    n, n_points=1, max_iters=4, seed=seed, **kw)
from benchmarks_torch import run
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    run.main(["--only", "fig4", "--device", "cpu"])
lines = buf.getvalue().splitlines()
ok = lines[0] == "name,us_per_call,derived" and len(lines) > 4
ok &= all(line.startswith("fig4,") for line in lines[1:])
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "benchmarks")
             or m.startswith(("jax.", "repro.", "benchmarks.")))
print(json.dumps({{"ok": bool(ok), "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=180, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "bad": []}


def test_harness_without_device_needs_cuda():
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmarks_torch.run",
                          "--only", "table2"], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "table2," not in out.stdout
