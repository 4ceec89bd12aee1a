"""The port's island campaigns held against `repro.evolve` on the CPU.

* The reference's campaign cases on the synthetic problem, ported and
  compared with the reference's archives: canonical order, migration,
  in-process resume, incompatible configs, serial against spawned
  workers, resume across worker counts, the memo's rows and bound.
* The real thing: a TNN campaign on breast_cancer over the reference's
  own Phase-1/2 products (a reference phase-cache entry, read by the
  port's `load_phase` through `build_tnn_problem(phase_key=...)`) gives
  the reference's archive X and F and island histories bit for bit,
  serially and with `workers=2`, and after a resume from a checkpoint the
  other framework wrote, in both directions; the fingerprints agree.
* Drift: after each of three `attach_tnn_drift` rounds the port's
  objective equals the reference's drifted objective and the port's own
  `_eval_one`, and a campaign stepped between drift rounds follows the
  reference's.
* The CLI: a campaign SIGKILLed after an epoch resumes through `python -m
  repro_torch.evolve` to the uninterrupted front, and `--emit-dir` writes
  a servable winner whose provenance names the device.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.evolve import Campaign as RefCampaign  # noqa: E402
from repro.evolve import CampaignConfig as RefConfig  # noqa: E402
from repro.evolve import build_synth_problem as ref_synth  # noqa: E402
from repro.evolve import phase_cache as RPC  # noqa: E402
from repro.evolve.problems import attach_tnn_drift as ref_drift  # noqa: E402
from repro.evolve.problems import build_tnn_problem as ref_build  # noqa: E402
from repro_torch.core.nsga2 import NSGA2Config, extract_front  # noqa: E402
from repro_torch.evolve import (  # noqa: E402
    Campaign,
    CampaignConfig,
    ParetoArchive,
    ProblemSpec,
    attach_tnn_drift,
    build_synth_problem,
    build_tnn_problem,
    migrate_ring,
)
from repro_torch.evolve.problems import clear_phase_memo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"
DATASET = "breast_cancer"
# Phase-1/2 budgets big enough for a front of ~10 designs (~9 s for the
# reference's pipeline on the CPU)
SMALL = dict(seed=0, epochs=4, cgp_points=2, cgp_iters=60, pcc_samples=2000)
TNN_CFG = dict(n_islands=3, pop_size=12, n_epochs=4, gens_per_epoch=3,
               migrate_k=2, seed=7)


def _cfg(**kw) -> CampaignConfig:
    base = dict(n_islands=3, pop_size=12, n_epochs=4, gens_per_epoch=3,
                migrate_k=2, seed=7)
    base.update(kw)
    return CampaignConfig(**base)


def _ref_cfg(**kw) -> RefConfig:
    base = dict(n_islands=3, pop_size=12, n_epochs=4, gens_per_epoch=3,
                migrate_k=2, seed=7)
    base.update(kw)
    return RefConfig(**base)


def _campaign(cfg=None, ckpt=None) -> Campaign:
    p = build_synth_problem()
    return Campaign(p.domains, p.objective, cfg or _cfg(),
                    checkpoint_dir=ckpt, name=p.name)


def _ref_synth_run(**kw):
    p = ref_synth()
    return RefCampaign(p.domains, p.objective, _ref_cfg(**kw),
                       name=p.name).run()


def _same(a, b):
    np.testing.assert_array_equal(a.archive_x, b.archive_x)
    np.testing.assert_array_equal(a.archive_f, b.archive_f)
    assert a.histories == b.histories


# ---------------------------------------------------------------------------
# The reference's campaign cases on the synthetic problem
# ---------------------------------------------------------------------------
def test_archive_is_nondominated_canonical_and_the_references():
    res = _campaign().run()
    F = res.archive_f
    assert len(F) > 0
    for i in range(len(F)):
        dominated = ((F <= F[i]).all(1) & (F < F[i]).any(1)).any()
        assert not dominated, f"archive row {i} is dominated"
    key = list(map(tuple, np.round(F, 12)))
    assert key == sorted(key)
    assert len(np.unique(res.archive_x, axis=0)) == len(res.archive_x)
    _same(res, _ref_synth_run())


def test_migration_moves_elites():
    c = _campaign()
    c.init_or_resume()
    for i, d in enumerate(c.drivers):
        c.states[i] = d.step(c.states[i])
    elite_x, _ = extract_front(c.states[0].pop, c.states[0].F)
    placed = migrate_ring(c.states, k=2)
    assert placed > 0
    assert any((row == elite_x[0]).all() for row in c.states[1].pop)


def test_migration_noop_for_single_island():
    c = _campaign(_cfg(n_islands=1))
    c.init_or_resume()
    assert migrate_ring(c.states, k=2) == 0


def test_archive_update_keeps_best():
    a = ParetoArchive(2)
    a.update(np.array([[0, 0], [1, 1]]), np.array([[1.0, 2.0], [2.0, 1.0]]))
    a.update(np.array([[2, 2]]), np.array([[0.5, 0.5]]))   # dominates both
    assert len(a) == 1 and a.F[0].tolist() == [0.5, 0.5]


def test_in_process_resume_bit_identical(tmp_path):
    full = _campaign(ckpt=str(tmp_path / "a")).run()
    stopped = _campaign(_cfg(n_epochs=2), ckpt=str(tmp_path / "b")).run()
    assert stopped.epochs_run == 2
    resumed = _campaign(ckpt=str(tmp_path / "b")).run()
    assert resumed.resumed_from == 1 and resumed.epochs_run == 2
    np.testing.assert_array_equal(full.archive_x, resumed.archive_x)
    np.testing.assert_array_equal(full.archive_f, resumed.archive_f)


def test_resume_rejects_incompatible_config(tmp_path):
    _campaign(ckpt=str(tmp_path)).run()
    for change in ({"pop_size": 8}, {"migrate_k": 0}, {"seed": 8},
                   {"base": NSGA2Config(mutation_eta=5.0)}):
        other = _campaign(_cfg(**change), ckpt=str(tmp_path))
        with pytest.raises(ValueError, match="incompatible campaign config"):
            other.run()
    # the device is no part of the trajectory: a resume may change it
    resumed = _campaign(_cfg(device="cpu", n_epochs=5), ckpt=str(tmp_path))
    assert resumed.run().resumed_from == 3


def test_fingerprint_equals_the_references():
    p, r = build_synth_problem(), ref_synth()
    for kw in ({}, {"seed": 3, "migrate_k": 1}, {"pop_size": 8}):
        mine = Campaign(p.domains, p.objective, _cfg(device="cpu", **kw))
        ref = RefCampaign(r.domains, r.objective, _ref_cfg(**kw))
        assert mine.fingerprint() == ref.fingerprint()
        assert mine._config_fingerprint() == ref._config_fingerprint()


def _spec_campaign(workers, ckpt=None, **kw) -> Campaign:
    spec = ProblemSpec("synth", {})
    p = spec.build()
    return Campaign(p.domains, p.objective, _cfg(workers=workers, **kw),
                    checkpoint_dir=ckpt, name=p.name, problem_spec=spec)


@pytest.mark.parametrize("workers", [1, 2])
def test_parallel_campaign_bit_identical(workers):
    serial = _campaign().run()
    with _spec_campaign(workers) as c:
        par = c.run()
    _same(serial, par)


def test_parallel_resume_crosses_worker_counts(tmp_path):
    full = _campaign().run()
    _campaign(_cfg(n_epochs=2), ckpt=str(tmp_path)).run()
    with _spec_campaign(2, ckpt=str(tmp_path)) as c:
        resumed = c.run()
    assert resumed.resumed_from == 1
    np.testing.assert_array_equal(full.archive_x, resumed.archive_x)
    np.testing.assert_array_equal(full.archive_f, resumed.archive_f)
    assert resumed.cache_history[-1]["mode"] == "parallel"
    assert resumed.cache_history[-1]["workers"] == 2
    assert resumed.cache_history[-1]["misses"] > 0


def test_workers_require_problem_spec():
    p = build_synth_problem()
    with pytest.raises(ValueError, match="problem_spec"):
        Campaign(p.domains, p.objective, _cfg(workers=2))


def test_executor_rejects_bare_callable():
    from repro_torch.evolve.executor import IslandExecutor
    with pytest.raises(TypeError, match="ProblemSpec"):
        IslandExecutor(lambda X: X, _cfg(workers=2))


def test_cache_history_rows_and_memo_bound():
    res = _campaign().run()
    assert len(res.cache_history) == _cfg().n_epochs
    last = res.cache_history[-1]
    assert last["mode"] == "serial" and last["epoch"] == _cfg().n_epochs - 1
    assert last["misses"] > 0 and last["hits"] >= 0
    assert last["maxsize"] == _cfg().memo_maxsize
    tiny = _campaign(_cfg(memo_maxsize=4))
    np.testing.assert_array_equal(res.archive_x, tiny.run().archive_x)
    info = tiny._evaluate.cache_info()
    assert info["evictions"] > 0 and info["size"] <= 4


def test_evaluator_reexports_the_dispatch():
    from repro_torch.evolve import evaluator
    from repro_torch.kernels import dispatch
    assert evaluator.population_eval_uint is dispatch.population_eval_uint
    assert evaluator.population_pc_errors is dispatch.population_pc_errors
    assert not hasattr(evaluator, "BACKENDS")


# ---------------------------------------------------------------------------
# TNN campaigns on the reference's Phase-1/2 products
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_products(tmp_path_factory):
    """The reference's pipeline run once into a phase cache: (root, key)."""
    root = tmp_path_factory.mktemp("phase_cache")
    ref_build(DATASET, cache_dir=str(root), **SMALL)
    return str(root), RPC.phase_key(DATASET, **SMALL)


def _port_spec(ref_products) -> ProblemSpec:
    root, key = ref_products
    return ProblemSpec("tnn", {"dataset": DATASET, "device": CPU,
                               "cache_dir": root, "phase_key": key,
                               **SMALL})


def _ref_problem(ref_products):
    root, _ = ref_products
    return ref_build(DATASET, cache_dir=root, **SMALL)


def _ref_campaign(ref_products, ckpt=None, **kw):
    p = _ref_problem(ref_products)
    return RefCampaign(p.domains, p.objective, _ref_cfg(**{**TNN_CFG, **kw}),
                       checkpoint_dir=ckpt,
                       seed_population=p.seed_population, name=p.name)


def _port_campaign(ref_products, ckpt=None, workers=0, **kw):
    spec = _port_spec(ref_products)
    p = spec.build()
    return Campaign(p.domains, p.objective,
                    _cfg(**{**TNN_CFG, **kw}, device=CPU, workers=workers),
                    checkpoint_dir=ckpt, seed_population=p.seed_population,
                    name=p.name, problem_spec=spec)


@pytest.fixture(scope="module")
def ref_tnn_run(ref_products):
    return _ref_campaign(ref_products).run()


def test_port_problem_loads_the_reference_products(ref_products):
    root, key = ref_products
    clear_phase_memo()
    ref, mine = _ref_problem(ref_products), _port_spec(ref_products).build()
    np.testing.assert_array_equal(mine.domains, ref.domains)
    np.testing.assert_array_equal(mine.tnn.w1t, ref.tnn.w1t)
    pop = np.random.default_rng(1).integers(
        0, ref.domains[None, :], size=(40, ref.domains.size))
    np.testing.assert_array_equal(mine.objective(pop), ref.objective(pop))
    with pytest.raises(FileNotFoundError, match="no phase-cache entry"):
        build_tnn_problem(DATASET, device=CPU, cache_dir=root,
                          phase_key="0" * 64, **SMALL)


@pytest.mark.parametrize("workers", [0, 2])
def test_tnn_campaign_equals_the_references(ref_products, ref_tnn_run,
                                            workers):
    with _port_campaign(ref_products, workers=workers) as c:
        mine = c.run()
    assert len(mine.archive_x) >= 5
    _same(mine, ref_tnn_run)
    assert mine.cache_history[-1]["mode"] == (
        "parallel" if workers else "serial")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_frameworks(ref_products, ref_tnn_run, tmp_path,
                                  writer):
    """A campaign stopped after two epochs by one package resumes in the
    other to the uninterrupted front."""
    first, then = ((_ref_campaign, _port_campaign) if writer == "reference"
                   else (_port_campaign, _ref_campaign))
    stopped = first(ref_products, ckpt=str(tmp_path), n_epochs=2).run()
    assert stopped.epochs_run == 2
    resumed = then(ref_products, ckpt=str(tmp_path)).run()
    assert resumed.resumed_from == 1 and resumed.epochs_run == 2
    _same(resumed, ref_tnn_run)


@pytest.mark.parametrize("rate", [0.25, 1.0])
def test_drift_moves_the_device_state(ref_products, rate):
    """Each round: the port's objective (read from its device state) equals
    the reference's drifted objective and the port's own `_eval_one`."""
    ref = ref_drift(_ref_problem(ref_products), rate, seed=3)
    mine = attach_tnn_drift(_port_spec(ref_products).build(), rate, seed=3)
    pop = np.random.default_rng(2).integers(
        0, ref.domains[None, :], size=(24, ref.domains.size))
    before = mine.objective(pop)
    for r in range(3):
        ref.drift(r)
        mine.drift(r)
        got = mine.objective(pop)
        np.testing.assert_array_equal(got, ref.objective(pop))
        np.testing.assert_array_equal(
            got, np.array([mine.approx._eval_one(x) for x in pop]))
        assert mine.approx._y_dev.tolist() == ref.approx.y.tolist()
    assert not np.array_equal(got, before)


def test_drifted_campaign_equals_the_references(ref_products):
    """Epochs stepped between drift rounds (`mark_drift` clears the memo)
    follow the reference's trajectory."""
    runs = []
    for p, drift, make, cfg in (
            (_ref_problem(ref_products), ref_drift, RefCampaign,
             _ref_cfg(**TNN_CFG)),
            (_port_spec(ref_products).build(), attach_tnn_drift, Campaign,
             _cfg(**TNN_CFG, device=CPU))):
        drift(p, 0.5, seed=1)
        c = make(p.domains, p.objective, cfg,
                 seed_population=p.seed_population)
        for r in range(3):
            p.drift(r)
            c.mark_drift(r)
            c.step_epoch()
        runs.append((c.archive.X, c.archive.F,
                     [s.history for s in c.states]))
    (xa, fa, ha), (xb, fb, hb) = runs
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(fa, fb)
    assert ha == hb


# ---------------------------------------------------------------------------
# The CLI: SIGKILL and resume, emit
# ---------------------------------------------------------------------------
def _cli(tmp, extra, timeout=240):
    cmd = [sys.executable, "-m", "repro_torch.evolve", "--problem", "synth",
           "--islands", "3", "--pop", "12", "--epochs", "4",
           "--gens-per-epoch", "3", "--seed", "7"] + extra
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_sigkill_resume_through_the_cli(tmp_path):
    r = _cli(tmp_path, ["--ckpt-dir", "ck", "--out", "front.json",
                        "--kill-after-epoch", "1"])
    assert r.returncode == -signal.SIGKILL
    assert not (tmp_path / "front.json").exists()
    r = _cli(tmp_path, ["--ckpt-dir", "ck", "--out", "front.json",
                        "--workers", "2"])
    assert r.returncode == 0, r.stderr
    assert "resumed from epoch 1" in r.stdout
    got = json.loads((tmp_path / "front.json").read_text())
    assert got["resumed_from"] == 1
    want = _ref_synth_run()
    assert got["archive"] == [
        {"x": x.tolist(), "f": [float(a), float(b)]}
        for x, (a, b) in zip(want.archive_x, want.archive_f)]
    assert got["config"]["workers"] == 2 and "backend" not in got["config"]


def test_cli_emits_a_servable_winner(ref_products, tmp_path):
    from repro_torch.compile import load_manifest, load_program
    from repro_torch.evolve import __main__ as cli

    root, key = ref_products
    emit = tmp_path / "emit"
    cli.main(["--problem", "tnn", "--dataset", DATASET, "--device", CPU,
              "--phase-cache", root, "--phase-key", key,
              "--islands", "2", "--pop", "8", "--epochs", "1",
              "--gens-per-epoch", "2", "--tnn-epochs", "4",
              "--cgp-points", "2", "--cgp-iters", "60",
              "--pcc-samples", "2000", "--emit-dir", str(emit),
              "--out", str(tmp_path / "front.json")])
    (row,) = load_manifest(emit)
    assert row["name"] == f"tnn_{DATASET}"
    assert row["provenance"]["device"] == "cpu"
    assert "backend" not in row["provenance"]
    prog = load_program(emit / row["program"], device=CPU,
                        expect_sha256=row["sha256"])
    assert prog.predict(np.zeros((3, row["n_features"]))).shape == (3,)
