"""The autopilot controller: evolve → compile → shadow-deploy → promote.

The port of `repro.autopilot.controller`, with the device in place of the
backend name: the campaign scores on its problem's device, and the shadow
serves on the incumbent's device unless `AutopilotConfig.shadow_device`
names another.

One `Autopilot` closes the loop the rest of the repo builds in pieces: a
resumable evolution `Campaign` keeps searching against (optionally
drifting) data, every improved Pareto winner is lowered through
`repro_torch.compile`, staged in the emit dir's ``candidates/`` sub-manifest
with full provenance, and deployed to the live `ClassifierFleet` as a
**shadow replica** of the incumbent tenant.  The fleet mirrors admitted
traffic to the shadow; a `ShadowComparator` accumulates agreement /
accuracy / latency evidence; and when enough mirrored pairs have scored,
`decide` turns the journaled evidence into a verdict:

  * **promote** — the candidate row is registered under the incumbent's
    name (one atomic manifest write that bumps the generation counter)
    and `sync_manifest()` swaps it into the serving slot without dropping
    a queued request;
  * **rollback** — the shadow is retired; the incumbent never noticed.

Every stage is journaled *before* it acts (`journal.py`), so a controller
SIGKILLed anywhere mid-rollout resumes to the same decision: evidence
already journaled is never re-measured, and `decide` is a pure function
of the journaled summary.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, Protocol

import numpy as np

from repro_torch.autopilot.journal import DecisionJournal
from repro_torch.compile import artifact as A
from repro_torch.compile.ir import CircuitIR, CompiledClassifier
from repro_torch.hw.egfet import Gate
from repro_torch.serve.fleet import ClassifierFleet, TenantSpec

TERMINAL_EVENTS = ("promoted", "rolled_back", "held", "no_candidate")
STAGES = ("candidate", "shadow", "verdict", "decision")
CANDIDATES_SUBDIR = "candidates"


# -- promotion policy --------------------------------------------------------
@dataclass(frozen=True)
class PromotionPolicy:
    """Thresholds `decide` applies to a comparator summary.

    Accuracy is the primary signal when the traffic source supplied
    ground truth (`min_truth` labeled pairs): an *improved* candidate
    legitimately disagrees with the incumbent, so raw agreement must not
    veto it.  Without enough labeled pairs the policy falls back to
    bit-agreement, where anything under `min_agreement` is treated as a
    broken artifact.  `max_latency_factor` (off by default — mirrored
    queues share machines with the incumbent, so wall-clock deltas are
    noisy at test scale) bounds shadow p50 as a multiple of incumbent p50.
    """

    min_pairs: int = 64
    min_agreement: float = 0.98
    min_truth: int = 32
    accuracy_margin: float = 0.0
    max_latency_factor: float | None = None


def decide(summary: dict, policy: PromotionPolicy) -> tuple[str, str]:
    """Pure verdict over a journaled comparator summary.

    Returns ``(action, reason)`` with action one of ``promote`` /
    ``rollback`` / ``hold``.  Purity is a resume guarantee, not a style
    choice: re-running this on the same journaled summary must reproduce
    the same decision (pinned by tests/test_torch_autopilot.py).
    """
    n = summary["n_pairs"]
    if summary.get("n_shadow_errors", 0) > 0:
        return "rollback", (f"shadow erred on {summary['n_shadow_errors']} "
                            "mirrored request(s)")
    if n < policy.min_pairs:
        return "hold", f"only {n}/{policy.min_pairs} scored pairs"
    if policy.max_latency_factor is not None:
        inc_p50 = summary.get("incumbent_p50_ms") or 0.0
        sh_p50 = summary.get("shadow_p50_ms") or 0.0
        if inc_p50 > 0.0 and sh_p50 > policy.max_latency_factor * inc_p50:
            return "rollback", (
                f"shadow p50 {sh_p50:.3f} ms exceeds "
                f"{policy.max_latency_factor}x incumbent p50 "
                f"{inc_p50:.3f} ms")
    if summary.get("n_truth", 0) >= policy.min_truth:
        inc_acc = summary["incumbent_accuracy"]
        sh_acc = summary["shadow_accuracy"]
        if sh_acc + 1e-12 >= inc_acc + policy.accuracy_margin:
            return "promote", (
                f"shadow accuracy {sh_acc:.4f} >= incumbent {inc_acc:.4f} "
                f"+ margin {policy.accuracy_margin} on "
                f"{summary['n_truth']} labeled pairs")
        return "rollback", (
            f"shadow accuracy {sh_acc:.4f} < incumbent {inc_acc:.4f} "
            f"+ margin {policy.accuracy_margin}")
    if summary["agreement"] >= policy.min_agreement:
        return "promote", (f"agreement {summary['agreement']:.4f} >= "
                           f"{policy.min_agreement} on {n} pairs "
                           "(no ground truth)")
    return "rollback", (f"agreement {summary['agreement']:.4f} < "
                        f"{policy.min_agreement} and no ground truth "
                        "to justify the disagreement")


# -- candidate sources -------------------------------------------------------
@dataclass
class Candidate:
    """One compiled design a source proposes for shadow verification."""

    cc: CompiledClassifier
    objectives: list[float]
    provenance: dict
    dataset: str | None = None


class CandidateSource(Protocol):
    def next_candidate(self, round_idx: int) -> Candidate | None: ...


class ScriptedSource:
    """Fixed per-round candidates — the deterministic test harness.

    Indexed by round (not consumed), so a resumed controller that skips
    an already-journaled round still sees the same candidate for the
    rounds it re-enters.
    """

    def __init__(self, candidates: list[Candidate | None]):
        self._candidates = list(candidates)

    def next_candidate(self, round_idx: int) -> Candidate | None:
        if round_idx < len(self._candidates):
            return self._candidates[round_idx]
        return None


class CampaignSource:
    """Steps a resumable `Campaign` and surfaces improved Pareto winners.

    Each round: apply the problem's drift hook (fresh data — and clear
    the campaign's memoized fitness cache, which is stale the moment the
    sample plane moves), run `epochs_per_round` checkpointed epochs, and
    lower the archive's best objective-0 chromosome iff it improved on
    the best already emitted (`require_improvement=False` emits every
    round's winner — useful when the incumbent's objective is unknown).
    """

    def __init__(self, problem, campaign, *, epochs_per_round: int = 1,
                 min_improve: float = 0.0, baseline_obj: float | None = None,
                 require_improvement: bool = True):
        self.problem = problem
        self.campaign = campaign
        self.epochs_per_round = epochs_per_round
        self.min_improve = min_improve
        self.best_obj = baseline_obj
        self.require_improvement = require_improvement

    def next_candidate(self, round_idx: int) -> Candidate | None:
        from repro_torch.evolve.problems import compile_archive_winner

        if self.problem.drift is not None:
            self.problem.drift(round_idx)
            # mark_drift (not bare clear_eval_cache): with a parallel
            # campaign the executor's workers must replay this round on
            # their own problem copies before stepping again
            self.campaign.mark_drift(round_idx)
        epoch = None
        for _ in range(self.epochs_per_round):
            epoch = self.campaign.step_epoch()
        x, f = self.campaign.best_by_objective(0)
        obj0 = float(f[0])
        if (self.require_improvement and self.best_obj is not None
                and obj0 >= self.best_obj - self.min_improve):
            return None
        self.best_obj = obj0
        cc = compile_archive_winner(self.problem, x)
        cfg = self.campaign.cfg
        return Candidate(
            cc=cc,
            objectives=[float(v) for v in f],
            provenance={
                "seed": cfg.seed,
                "islands": cfg.n_islands,
                "pop_size": cfg.pop_size,
                "generations": (epoch + 1) * cfg.gens_per_epoch,
                "objectives": [float(v) for v in f],
                "config_fingerprint": self.campaign.fingerprint(),
                "device": str(self.problem.approx.device
                              if self.problem.approx is not None
                              else cfg.device),
                "drift_round": (round_idx if self.problem.drift is not None
                                else None),
            },
            dataset=(self.problem.dataset.name
                     if self.problem.dataset is not None else None))


# -- traffic + sabotage ------------------------------------------------------
def dataset_traffic(dataset, batch: int = 32,
                    seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Deterministic infinite `(X, y)` batches from a dataset's test split."""
    if isinstance(dataset, str):
        from repro_torch.data.tabular import make_dataset
        dataset = make_dataset(dataset)
    X = np.asarray(dataset.x_test, dtype=np.float64)
    y = np.asarray(dataset.y_test, dtype=np.int64)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, X.shape[0], size=batch)
        yield X[idx], y[idx]


def sabotage_classifier(cc: CompiledClassifier) -> CompiledClassifier:
    """Deterministically break a classifier: NOT-gate the label's LSB.

    Appending one NOT gate rewired over ``outputs[0]`` flips the low bit
    of *every* predicted class index, so the sabotaged design disagrees
    with the original on 100% of inputs — a worst-case bad artifact for
    rollback drills (probabilistic corruptions like threshold jitter can
    accidentally still agree).  The IR stays levelized and feed-forward,
    so it lowers, saves, and serves like any legitimate candidate.
    """
    ir = cc.ir
    node = ir.n_inputs + ir.n_gates
    src = np.int32(ir.outputs[0])
    outputs = ir.outputs.copy()
    outputs[0] = node
    lvl = (int(ir.levels.max()) + 1) if ir.n_gates else 1
    ir2 = CircuitIR(
        n_inputs=ir.n_inputs,
        op=np.append(ir.op, np.int16(Gate.NOT)).astype(np.int16),
        in0=np.append(ir.in0, src).astype(np.int32),
        in1=np.append(ir.in1, src).astype(np.int32),
        outputs=outputs.astype(np.int32),
        levels=np.append(ir.levels, np.int32(lvl)).astype(np.int32),
        taps={k: v.copy() for k, v in ir.taps.items()},
        name=(ir.name or "classifier") + "_sabotaged",
        meta=dict(ir.meta))
    ir2.to_netlist()                    # still a valid feed-forward circuit
    return dataclasses.replace(cc, ir=ir2,
                               name=(cc.name or "classifier") + "_sabotaged")


# -- the controller ----------------------------------------------------------
@dataclass
class AutopilotConfig:
    tenant: str                          # incumbent tenant to improve
    rounds: int = 1
    mirror_pairs: int = 128              # scored pairs needed per verdict
    traffic_batch: int = 32
    verdict_timeout_s: float = 120.0
    shadow_device: str | None = None     # default: the incumbent's device
    shadow_replicas: int = 1
    shadow_max_queue: int | None = 1024
    policy: PromotionPolicy = field(default_factory=PromotionPolicy)
    sabotage_rounds: frozenset = frozenset()
    # debug hook for resume tests: SIGKILL self right after journaling
    # stage (one of STAGES) of the given round
    kill_after: tuple[str, int] | None = None


class Autopilot:
    """Drives rollout rounds against one live fleet, journaling each step."""

    def __init__(self, fleet: ClassifierFleet, source: CandidateSource,
                 traffic: Iterator[tuple[np.ndarray, np.ndarray]],
                 journal: DecisionJournal, cfg: AutopilotConfig,
                 on_event: Callable[[dict], None] | None = None):
        if fleet._manifest_ctx is None:
            raise ValueError("autopilot needs a fleet built by "
                             "ClassifierFleet.from_emit_dir (promotion is a "
                             "manifest write + sync)")
        if cfg.tenant not in fleet._tenants:
            raise KeyError(f"incumbent tenant {cfg.tenant!r} is not served "
                           f"by this fleet (serving: "
                           f"{', '.join(fleet.tenants)})")
        self.fleet = fleet
        self.source = source
        self.traffic = traffic
        self.journal = journal
        self.cfg = cfg
        self.emit_dir = Path(fleet._manifest_ctx["emit_dir"])
        self._on_event = on_event

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> list[dict]:
        """Run (or resume) every configured round; returns terminal events."""
        outcomes = []
        for r in range(self.cfg.rounds):
            out = self.run_round(r)
            if out is not None:
                outcomes.append(out)
        return outcomes

    def run_round(self, r: int) -> dict | None:
        """One rollout round, resuming mid-round from the journal.

        Already-journaled stages are *reused*, never re-executed:
        evidence measured before a crash governs the decision after it.
        """
        events = {}
        for ev in self.journal.rounds().get(r, []):
            events[ev["event"]] = ev        # last occurrence wins
        for terminal in TERMINAL_EVENTS:
            if terminal in events:
                return events[terminal]

        cand = events.get("candidate")
        if cand is None:
            candidate = self.source.next_candidate(r)
            if candidate is None:
                return self._journal("no_candidate", round=r)
            if r in self.cfg.sabotage_rounds:
                candidate = dataclasses.replace(
                    candidate, cc=sabotage_classifier(candidate.cc),
                    provenance={**candidate.provenance, "sabotaged": True})
            cand = self._stage_candidate(r, candidate)
        self._maybe_kill("candidate", r)

        verdict = events.get("verdict")
        if verdict is None:
            summary = self._shadow_and_measure(r, cand)
            verdict = self._journal("verdict", round=r, summary=summary)
        self._maybe_kill("verdict", r)

        decision = events.get("decision")
        if decision is None:
            action, reason = decide(verdict["summary"], self.cfg.policy)
            decision = self._journal("decision", round=r, action=action,
                                     reason=reason)
        self._maybe_kill("decision", r)

        return self._execute(r, cand, decision)

    # -- stages --------------------------------------------------------------
    def _journal(self, event: str, **fields) -> dict:
        row = self.journal.append(event, **fields)
        if self._on_event is not None:
            self._on_event(row)
        return row

    def _maybe_kill(self, stage: str, r: int) -> None:
        if self.cfg.kill_after == (stage, r):
            os.kill(os.getpid(), signal.SIGKILL)

    def _stage_candidate(self, r: int, candidate: Candidate) -> dict:
        """Lower the candidate into ``<emit_dir>/candidates/`` and journal it.

        The staging area is its own manifest directory, so candidates are
        registered with full provenance *without* becoming routable rows
        of the serving manifest — only a promotion writes those.
        """
        base = f"{self.cfg.tenant}__cand_r{r}"
        cand_dir = self.emit_dir / CANDIDATES_SUBDIR
        cand_dir.mkdir(parents=True, exist_ok=True)
        ppath = cand_dir / f"{base}{A.PROGRAM_SUFFIX}"
        A.save_program(candidate.cc, ppath)
        sha = ppath.with_name(ppath.name + A.SHA_SUFFIX).read_text().strip()
        cc = candidate.cc
        A.register_tenant(cand_dir, {
            "name": base,
            "program": str(ppath),
            "dataset": candidate.dataset,
            "n_features": cc.n_features,
            "n_classes": cc.n_classes,
            "n_gates": cc.ir.n_gates,
            "replicas": self.cfg.shadow_replicas,
            "sha256": sha,
            "provenance": dict(candidate.provenance),
        })
        return self._journal(
            "candidate", round=r, name=base,
            program=str(ppath.relative_to(self.emit_dir)), sha256=sha,
            objectives=candidate.objectives, dataset=candidate.dataset,
            n_features=cc.n_features, n_classes=cc.n_classes,
            provenance=dict(candidate.provenance))

    def _shadow_and_measure(self, r: int, cand: dict) -> dict:
        """Deploy the staged candidate as a shadow and mirror traffic at it
        until the comparator has `mirror_pairs` scored pairs (or the
        verdict timeout lapses — the policy then holds/rolls back on
        whatever evidence exists)."""
        from repro_torch.compile.artifact import load_program

        of = self.cfg.tenant
        shadow_name = f"{of}!shadow"
        if of in self.fleet._shadows:
            comp = self.fleet.shadow_comparator(of)
        else:
            device = self.cfg.shadow_device or self.fleet.tenant_device(of)
            program = load_program(self.emit_dir / cand["program"],
                                   device=device,
                                   expect_sha256=cand["sha256"])
            # best_effort: mirrored traffic yields scheduling priority to
            # every serving tenant; shadows are additionally invisible to
            # the fleet autoscaler (it never resizes a shadow pool — that
            # would skew the very comparison this deploy exists to make)
            spec = TenantSpec(
                name=shadow_name, program=program, device=device,
                replicas=self.cfg.shadow_replicas,
                max_queue=self.cfg.shadow_max_queue,
                qos="best_effort",
                dataset=cand.get("dataset"), sha256=cand["sha256"],
                meta={"candidate": cand["name"]})
            comp = self.fleet.deploy_shadow(spec, of)
            self._journal("shadow_deployed", round=r, name=shadow_name,
                          candidate=cand["name"], sha256=cand["sha256"])
        self._maybe_kill("shadow", r)
        deadline = time.monotonic() + self.cfg.verdict_timeout_s
        while comp.n_pairs < self.cfg.mirror_pairs:
            if time.monotonic() > deadline:
                break
            X, y = next(self.traffic)
            reqs, _, _ = self.fleet.submit_many(of, X)
            for req, label in zip(reqs, y):
                comp.attach_truth(req.uid, int(label))
            self.fleet.flush(timeout=self.cfg.verdict_timeout_s)
        return comp.summary()

    def _execute(self, r: int, cand: dict, decision: dict) -> dict:
        action = decision["action"]
        of = self.cfg.tenant
        if action == "promote":
            if of in self.fleet._shadows:   # absent after a crash-resume
                self.fleet.retire_shadow(of)
            generation = self._register_promotion(cand)
            actions = self.fleet.sync_manifest()
            return self._journal("promoted", round=r, candidate=cand["name"],
                                 sha256=cand["sha256"],
                                 generation=generation,
                                 replaced=actions["replaced"])
        if of in self.fleet._shadows:
            self.fleet.retire_shadow(of)
        event = "rolled_back" if action == "rollback" else "held"
        return self._journal(event, round=r, candidate=cand["name"],
                             reason=decision["reason"])

    def _register_promotion(self, cand: dict) -> int:
        """One atomic manifest write: the staged candidate becomes the
        incumbent's row, bumping the generation counter the fleet's
        replace machinery keys on.  Needs only journaled facts + staged
        files, so a resumed controller can re-execute it without the
        in-memory `CompiledClassifier`."""
        of = self.cfg.tenant
        incumbent = self.fleet._tenant(of)
        A.register_tenant(self.emit_dir, {
            "name": of,
            "program": str(self.emit_dir / cand["program"]),
            "dataset": cand.get("dataset") or incumbent.spec.dataset,
            "n_features": cand["n_features"],
            "n_classes": cand["n_classes"],
            "replicas": incumbent.pool.size,
            "sha256": cand["sha256"],
            "provenance": dict(cand.get("provenance", {})),
        })
        return int(A.load_manifest_doc(self.emit_dir)["generation"])
