"""The port's autopilot held against `repro.autopilot` on the CPU.

* The journal: sequence numbers survive a reopen, a torn tail is dropped
  and mid-file corruption raises; each package replays the other's file.
* `decide` gives the reference's verdict and reason on the reference
  test's matrix and on a seeded grid of summaries; `sabotage_classifier`
  gives the reference's IR.
* The controller on a scripted bad -> good sequence over a CPU fleet:
  rollback then promotion (the manifest generation flips, the fleet
  follows, the staged candidates carry provenance), the same events and
  decisions as the reference's controller on the same candidates and
  traffic, the sabotage hook, `no_candidate`, an idempotent rerun.
* SIGKILL: a controller killed after journaling a verdict, or between a
  decision and its execution, resumes in a fresh process to the decisions
  of an uninterrupted run.
* The CLI end to end: `python -m repro_torch.autopilot run --device cpu`
  over a campaign's winner (a sabotaged round rolls back, a good one
  promotes), then `status`, and the operator's `promote` / `rollback`.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.autopilot as PA  # noqa: E402
from repro import autopilot as RA  # noqa: E402
from repro.compile import lower_classifier as ref_lower  # noqa: E402
from repro.compile.verilog import write_artifacts as ref_write  # noqa: E402
from repro.core import tnn as RT  # noqa: E402
from repro.serve import ClassifierFleet as RefFleet  # noqa: E402
from repro_torch.autopilot import (  # noqa: E402
    Autopilot,
    AutopilotConfig,
    Candidate,
    DecisionJournal,
    JournalCorruptError,
    PromotionPolicy,
    ScriptedSource,
    decide,
    sabotage_classifier,
)
from repro_torch.compile import (  # noqa: E402
    CircuitProgram,
    load_manifest_doc,
    load_program,
    lower_classifier,
    write_artifacts,
)
from repro_torch.core import tnn as T  # noqa: E402
from repro_torch.serve import ClassifierFleet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"


def _toy_tnn(mod, F=9, H=5, Cc=4, seed=7):
    rng = np.random.default_rng(seed)
    w1t = rng.integers(-1, 2, size=(F, H)).astype(np.int8)
    w2t = mod.balance_zero_counts(rng.normal(size=(H, Cc)), 1 / 3)
    return mod.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(F, 0.5),
                          train_acc=0.0, test_acc=0.0, name=f"toy{seed}")


def _toy_classifier(seed=7):
    tnn = _toy_tnn(T, seed=seed)
    return lower_classifier(tnn, *T.exact_netlists(tnn))


def _ref_toy_classifier(seed=7):
    tnn = _toy_tnn(RT, seed=seed)
    return ref_lower(tnn, *RT.exact_netlists(tnn))


@pytest.fixture
def emit_dir(tmp_path):
    write_artifacts(_toy_classifier(), tmp_path / "port", base="alpha",
                    provenance={"seed": 7, "objectives": [0.25, 1.0]})
    return tmp_path / "port"


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_roundtrip_across_packages(tmp_path, writer):
    path = tmp_path / "j.jsonl"
    first, then = ((DecisionJournal, RA.DecisionJournal) if writer == "port"
                   else (RA.DecisionJournal, DecisionJournal))
    j = first(path)
    j.append("candidate", round=0, name="a")
    j.append("verdict", round=0, summary={"n_pairs": 3})
    j2 = then(path)                               # reopen: replay + resume
    events = j2.replay()
    assert [e["event"] for e in events] == ["candidate", "verdict"]
    assert [e["seq"] for e in events] == [1, 2]
    assert j2.append("decision", round=0, action="hold")["seq"] == 3
    assert set(j2.rounds()) == {0}
    assert DecisionJournal(path).replay() == RA.DecisionJournal(path).replay()


def test_journal_tolerates_torn_tail_but_not_mid_corruption(tmp_path):
    path = tmp_path / "j.jsonl"
    j = DecisionJournal(path)
    j.append("candidate", round=0, name="a")
    j.append("verdict", round=0, summary={})
    with open(path, "a") as f:
        f.write('{"seq": 3, "event": "decis')        # crash mid-append
    assert [e["event"] for e in DecisionJournal(path).replay()] == \
        ["candidate", "verdict"]
    lines = path.read_text().splitlines()
    lines[0] = "garbage{{{"
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorruptError):
        DecisionJournal(path)


# ---------------------------------------------------------------------------
# decide() and sabotage
# ---------------------------------------------------------------------------
def _summary(**kw):
    base = {"n_pairs": 100, "n_agree": 100, "agreement": 1.0,
            "n_shadow_errors": 0, "n_truth": 0,
            "incumbent_accuracy": None, "shadow_accuracy": None,
            "incumbent_p50_ms": 1.0, "shadow_p50_ms": 1.0}
    return {**base, **kw}


def _policies(mod):
    return [mod.PromotionPolicy(min_pairs=64, min_agreement=0.98,
                                min_truth=32),
            mod.PromotionPolicy(min_pairs=64, max_latency_factor=4.0),
            mod.PromotionPolicy(min_pairs=16, accuracy_margin=0.05,
                                min_truth=8)]


def test_decide_policy_matrix():
    pol = PromotionPolicy(min_pairs=64, min_agreement=0.98, min_truth=32)
    assert decide(_summary(), pol)[0] == "promote"
    assert decide(_summary(n_pairs=10), pol)[0] == "hold"
    assert decide(_summary(n_shadow_errors=2), pol)[0] == "rollback"
    assert decide(_summary(agreement=0.5), pol)[0] == "rollback"
    better = _summary(agreement=0.7, n_truth=50,
                      incumbent_accuracy=0.80, shadow_accuracy=0.90)
    assert decide(better, pol)[0] == "promote"
    worse = _summary(agreement=0.99, n_truth=50,
                     incumbent_accuracy=0.90, shadow_accuracy=0.80)
    assert decide(worse, pol)[0] == "rollback"
    slow = _summary(shadow_p50_ms=9.0)
    assert decide(slow, PromotionPolicy(min_pairs=64,
                                        max_latency_factor=4.0))[0] == \
        "rollback"
    assert decide(slow, pol)[0] == "promote"


def test_decide_equals_the_references_on_a_seeded_grid():
    rng = np.random.default_rng(0)
    summaries = []
    for _ in range(300):
        n = int(rng.integers(0, 200))
        truth = int(rng.integers(0, 80))
        summaries.append(_summary(
            n_pairs=n, agreement=float(rng.choice([0.5, 0.97, 0.98, 1.0])),
            n_shadow_errors=int(rng.random() < 0.1), n_truth=truth,
            incumbent_accuracy=float(rng.choice([0.8, 0.85, 0.9])),
            shadow_accuracy=float(rng.choice([0.8, 0.85, 0.9, 0.95])),
            incumbent_p50_ms=float(rng.choice([0.0, 1.0, 2.0])),
            shadow_p50_ms=float(rng.choice([1.0, 5.0, 9.0]))))
    for mine, ref in zip(_policies(PA), _policies(RA)):
        for s in summaries:
            assert decide(s, mine) == RA.decide(s, ref)


def test_sabotage_equals_the_references():
    mine = sabotage_classifier(_toy_classifier())
    ref = RA.sabotage_classifier(_ref_toy_classifier())
    for k in ("op", "in0", "in1", "outputs", "levels"):
        np.testing.assert_array_equal(getattr(mine.ir, k), getattr(ref.ir, k))
    assert mine.name == ref.name and mine.ir.name == ref.ir.name
    x = np.random.default_rng(1).random((40, 9))
    good = CircuitProgram.from_classifier(_toy_classifier(), device=CPU)
    bad = CircuitProgram.from_classifier(mine, device=CPU)
    assert (good.predict(x) != bad.predict(x)).all()


# ---------------------------------------------------------------------------
# The controller: bad candidate rolls back, good one promotes
# ---------------------------------------------------------------------------
def _traffic(predict):
    rng = np.random.default_rng(42)
    while True:
        X = rng.random((16, 9))
        yield X, predict(X)          # incumbent's own labels as ground truth


def _pilot(fleet, emit_dir, candidates, journal=None, mod=PA, **cfg_kw):
    """A controller of package `mod` over `fleet`; the traffic's labels are
    the incumbent's own (the port's program gives the reference's)."""
    ref = CircuitProgram.from_classifier(_toy_classifier(),
                                         device=CPU).predict
    cfg_kw.setdefault("policy", mod.PromotionPolicy(min_pairs=32,
                                                    min_truth=16))
    cfg = mod.AutopilotConfig(tenant="alpha", rounds=len(candidates),
                              mirror_pairs=48, verdict_timeout_s=60.0,
                              **cfg_kw)
    journal = journal or mod.DecisionJournal(emit_dir / "journal.jsonl")
    return mod.Autopilot(fleet, mod.ScriptedSource(candidates),
                         _traffic(ref), journal, cfg), journal


def _bad_good(mod, make):
    cc = make()
    return [mod.Candidate(cc=mod.sabotage_classifier(cc),
                          objectives=[0.2, 1.0],
                          provenance={"round": 0, "sabotaged": True}),
            mod.Candidate(cc=cc, objectives=[0.2, 1.0],
                          provenance={"round": 1})]


def _decisions(journal):
    return [(e["round"], e["event"], e.get("action"),
             e.get("summary", {}).get("n_pairs"),
             e.get("summary", {}).get("agreement"),
             e.get("summary", {}).get("shadow_accuracy"))
            for e in journal.replay()
            if e["event"] in ("verdict", "decision", "promoted",
                              "rolled_back")]


def test_autopilot_rolls_back_bad_then_promotes_good(emit_dir, tmp_path):
    gen0 = load_manifest_doc(emit_dir)["generation"]
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU) as fleet:
        pilot, journal = _pilot(fleet, emit_dir, _bad_good(PA,
                                                          _toy_classifier))
        outcomes = pilot.run()
        assert [o["event"] for o in outcomes] == ["rolled_back", "promoted"]
        doc = load_manifest_doc(emit_dir)
        assert doc["generation"] > gen0
        assert outcomes[1]["generation"] == doc["generation"]
        row = {t["name"]: t for t in doc["tenants"]}["alpha"]
        assert row["sha256"] == outcomes[1]["sha256"]
        assert row["provenance"]["round"] == 1
        t = fleet._tenant("alpha")
        assert t.spec.generation == doc["generation"]
        assert t.spec.sha256 == row["sha256"]
        assert "alpha" not in fleet._shadows
        assert fleet.errors == []
        cand_doc = load_manifest_doc(emit_dir / "candidates")
        cands = {t["name"]: t for t in cand_doc["tenants"]}
        assert set(cands) == {"alpha__cand_r0", "alpha__cand_r1"}
        assert cands["alpha__cand_r0"]["provenance"]["sabotaged"] is True
        for r, want in ((0, "rollback"), (1, "promote")):
            evs = {e["event"]: e for e in journal.rounds()[r]}
            assert decide(evs["verdict"]["summary"], pilot.cfg.policy)[0] \
                == want == evs["decision"]["action"]
        X = np.random.default_rng(9).random((8, 9))
        reqs, _, _ = fleet.submit_many("alpha", X)
        fleet.flush()
        np.testing.assert_array_equal(
            [r.result(5.0) for r in reqs],
            CircuitProgram.from_classifier(_toy_classifier(),
                                           device=CPU).predict(X))
    # the reference's controller on the same candidates and traffic
    ref_emit = tmp_path / "ref"
    ref_write(_ref_toy_classifier(), ref_emit, base="alpha",
              provenance={"seed": 7, "objectives": [0.25, 1.0]})
    with RefFleet.from_emit_dir(ref_emit, backends="np") as rfleet:
        rpilot, rjournal = _pilot(rfleet, ref_emit,
                                  _bad_good(RA, _ref_toy_classifier),
                                  mod=RA)
        assert [o["event"] for o in rpilot.run()] == \
            ["rolled_back", "promoted"]
    assert _decisions(journal) == _decisions(rjournal)


def test_autopilot_sabotage_rounds_hook_and_no_candidate(emit_dir):
    cc = _toy_classifier()
    candidates = [Candidate(cc=cc, objectives=[0.2, 1.0], provenance={}),
                  None]
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU) as fleet:
        pilot, _ = _pilot(fleet, emit_dir, candidates,
                          sabotage_rounds=frozenset({0}))
        outcomes = pilot.run()
    assert [o["event"] for o in outcomes] == ["rolled_back", "no_candidate"]


def test_autopilot_rerun_is_idempotent(emit_dir):
    cc = _toy_classifier()
    candidates = [Candidate(cc=cc, objectives=[0.2, 1.0], provenance={})]
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU) as fleet:
        pilot, _ = _pilot(fleet, emit_dir, candidates,
                          shadow_device=CPU)
        first = pilot.run()
        gen = load_manifest_doc(emit_dir)["generation"]
        assert pilot.run() == first          # every round already terminal
        assert load_manifest_doc(emit_dir)["generation"] == gen


def test_autopilot_needs_a_manifest_fleet_and_a_served_tenant(emit_dir):
    from repro_torch.serve import TenantSpec

    prog = CircuitProgram.from_classifier(_toy_classifier(), device=CPU)
    with ClassifierFleet([TenantSpec(name="alpha", program=prog,
                                     device=CPU)]) as bare:
        with pytest.raises(ValueError, match="from_emit_dir"):
            _pilot(bare, emit_dir, [None])
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU) as fleet:
        with pytest.raises(KeyError, match="not served"):
            Autopilot(fleet, ScriptedSource([]), iter(()),
                      DecisionJournal(emit_dir / "j.jsonl"),
                      AutopilotConfig(tenant="beta"))


# ---------------------------------------------------------------------------
# SIGKILL resume: the journaled verdict governs the post-crash decision
# ---------------------------------------------------------------------------
_CONTROLLER_SCRIPT = textwrap.dedent("""\
    import json, sys
    import numpy as np
    from pathlib import Path

    from repro_torch.autopilot import (Autopilot, AutopilotConfig,
                                       Candidate, DecisionJournal,
                                       PromotionPolicy, ScriptedSource,
                                       sabotage_classifier)
    from repro_torch.compile import (CircuitProgram, lower_classifier,
                                     write_artifacts)
    from repro_torch.core import tnn as T
    from repro_torch.serve import ClassifierFleet

    def toy(seed=7):
        rng = np.random.default_rng(seed)
        w1t = rng.integers(-1, 2, size=(9, 5)).astype(np.int8)
        w2t = T.balance_zero_counts(rng.normal(size=(5, 4)), 1 / 3)
        tnn = T.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(9, 0.5),
                           train_acc=0.0, test_acc=0.0, name="toy7")
        return lower_classifier(tnn, *T.exact_netlists(tnn))

    emit_dir = Path(sys.argv[1])
    kill_after = None
    if len(sys.argv) > 2 and sys.argv[2] != "-":
        stage, rnd = sys.argv[2].split(":")
        kill_after = (stage, int(rnd))

    cc = toy()
    if not (emit_dir / "fleet.json").exists():
        write_artifacts(cc, emit_dir, base="alpha")
    ref = CircuitProgram.from_classifier(cc, device="cpu").predict
    rng = np.random.default_rng(42)

    def traffic():
        while True:
            X = rng.random((16, 9))
            yield X, ref(X)

    candidates = [
        Candidate(cc=sabotage_classifier(cc), objectives=[0.2, 1.0],
                  provenance={"round": 0}),
        Candidate(cc=cc, objectives=[0.2, 1.0], provenance={"round": 1}),
    ]
    cfg = AutopilotConfig(
        tenant="alpha", rounds=2, mirror_pairs=48,
        policy=PromotionPolicy(min_pairs=32, min_truth=16),
        kill_after=kill_after)
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device="cpu")
    try:
        pilot = Autopilot(fleet, ScriptedSource(candidates), traffic(),
                          DecisionJournal(emit_dir / "journal.jsonl"), cfg)
        outcomes = pilot.run()
        print(json.dumps([(o["round"], o["event"]) for o in outcomes]))
    finally:
        fleet.shutdown(drain=False)
""")


def _run_controller(tmp_path, emit_dir, kill_after="-", timeout=180):
    script = tmp_path / "controller.py"
    script.write_text(_CONTROLLER_SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, str(script), str(emit_dir), kill_after],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout)


def test_sigkilled_controller_resumes_to_same_decision(tmp_path):
    killed = tmp_path / "killed"
    control = tmp_path / "control"
    r = _run_controller(tmp_path, control)
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    r1 = _run_controller(tmp_path, killed, kill_after="verdict:0")
    assert r1.returncode == -signal.SIGKILL
    evs = {e["event"] for e in
           DecisionJournal(killed / "journal.jsonl").rounds()[0]}
    assert "verdict" in evs and "decision" not in evs   # died mid-rollout
    r2 = _run_controller(tmp_path, killed)
    assert r2.returncode == 0, r2.stderr
    got = json.loads(r2.stdout.strip().splitlines()[-1])
    assert got == want == [[0, "rolled_back"], [1, "promoted"]]
    verdicts = [e for e in DecisionJournal(killed / "journal.jsonl")
                .rounds()[0] if e["event"] == "verdict"]
    assert len(verdicts) == 1          # recomputed from the journal


def test_sigkill_between_decision_and_execution_still_promotes(tmp_path):
    emit = tmp_path / "emit"
    r1 = _run_controller(tmp_path, emit, kill_after="decision:1")
    assert r1.returncode == -signal.SIGKILL
    evs = {e["event"]: e for e in
           DecisionJournal(emit / "journal.jsonl").rounds()[1]}
    assert evs["decision"]["action"] == "promote" and "promoted" not in evs
    gen_before = load_manifest_doc(emit)["generation"]
    r2 = _run_controller(tmp_path, emit)
    assert r2.returncode == 0, r2.stderr
    assert json.loads(r2.stdout.strip().splitlines()[-1]) == \
        [[0, "rolled_back"], [1, "promoted"]]
    doc = load_manifest_doc(emit)
    assert doc["generation"] > gen_before       # the journaled promotion ran
    row = {t["name"]: t for t in doc["tenants"]}["alpha"]
    cand = {e["event"]: e for e in
            DecisionJournal(emit / "journal.jsonl").rounds()[1]}["candidate"]
    assert row["sha256"] == cand["sha256"]
    assert load_program(emit / cand["program"], device=CPU,
                        expect_sha256=cand["sha256"]).n_classes == 4


# ---------------------------------------------------------------------------
# The CLI over a real campaign
# ---------------------------------------------------------------------------
TINY = dict(seed=0, epochs=2, cgp_points=1, cgp_iters=25, pcc_samples=400)
BUDGET_FLAGS = ["--tnn-epochs", "2", "--cgp-points", "1", "--cgp-iters",
                "25", "--pcc-samples", "400"]


def test_cli_run_status_promote_rollback(tmp_path, capsys):
    from repro_torch.autopilot import __main__ as cli
    from repro_torch.evolve import __main__ as evolve_cli

    cache, emit = tmp_path / "cache", tmp_path / "fleet"
    evolve_cli.main(["--problem", "tnn", "--dataset", "breast_cancer",
                     "--device", CPU, "--phase-cache", str(cache),
                     "--islands", "2", "--pop", "8", "--epochs", "1",
                     "--gens-per-epoch", "2", "--emit-dir", str(emit)]
                    + BUDGET_FLAGS)
    gen0 = load_manifest_doc(emit)["generation"]
    args = ["run", "--emit-dir", str(emit), "--tenant",
            "tnn_breast_cancer", "--dataset", "breast_cancer",
            "--device", CPU, "--phase-cache", str(cache), "--rounds", "2",
            "--islands", "2", "--pop", "8", "--gens-per-epoch", "2",
            "--mirror-pairs", "64", "--min-pairs", "32", "--min-truth",
            "16", "--sabotage-round", "0", "--no-require-improvement",
            "--drift-rate", "0.25", "--out", str(tmp_path / "ap.json")
            ] + BUDGET_FLAGS
    assert cli.main(args) == 0
    rep = json.loads((tmp_path / "ap.json").read_text())
    assert [o["event"] for o in rep["outcomes"]] == \
        ["rolled_back", "promoted"]
    assert rep["generation"] > gen0
    cands = {t["name"]: t for t in
             load_manifest_doc(emit / "candidates")["tenants"]}
    prov = cands["tnn_breast_cancer__cand_r1"]["provenance"]
    assert prov["device"] == "cpu" and prov["drift_round"] == 1
    assert "backend" not in prov
    assert cli.main(args) == 0                    # rerun: nothing new
    capsys.readouterr()
    assert cli.main(["status", "--emit-dir", str(emit), "--json"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["rounds"]["0"]["stage"] == "rolled_back"
    assert status["rounds"]["1"]["stage"] == "promoted"
    # operator overrides on open rounds of a stopped controller
    j = DecisionJournal(emit / "autopilot_journal.jsonl")
    for r in (5, 6):
        c = {e["event"]: e for e in j.rounds()[1]}["candidate"]
        j.append("candidate", **{**{k: v for k, v in c.items()
                                    if k not in ("seq", "event", "t")},
                                 "round": r})
    assert cli.main(["promote", "--emit-dir", str(emit), "--round",
                     "5"]) == 0
    assert cli.main(["rollback", "--emit-dir", str(emit), "--round",
                     "6"]) == 0
    states = {int(k): v["stage"] for k, v in
              _status(cli, emit, capsys)["rounds"].items()}
    assert states[5] == "promoted" and states[6] == "rolled_back"
    with pytest.raises(SystemExit, match="already closed"):
        cli.main(["rollback", "--emit-dir", str(emit), "--round", "5"])


def _status(cli, emit, capsys):
    capsys.readouterr()
    cli.main(["status", "--emit-dir", str(emit), "--json"])
    return json.loads(capsys.readouterr().out)
