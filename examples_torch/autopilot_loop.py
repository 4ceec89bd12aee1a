"""The autopilot, end to end: evolve -> shadow-verify -> promote, live.

Seeds a serving directory with a quick exact-TNN tenant for
breast_cancer, stands it up as a live `ClassifierFleet`, and then lets
`repro_torch.autopilot` run three rollout rounds against mirrored traffic:

  1. **rollback drill** — round 0's candidate is deliberately sabotaged
     (`sabotage_classifier` flips the label LSB on every input), so the
     shadow disagrees with the incumbent on all mirrored pairs and the
     controller auto-rolls-back.  The incumbent's stats and error log
     never notice.
  2. **real promotion** — round 1 ships the evolution campaign's best
     Pareto winner; the shadow's accuracy on live labeled traffic meets
     the incumbent's, and one atomic manifest write (generation bump +
     `sync_manifest`) swaps it into the serving slot with queued requests
     intact.
  3. **drift** — round 2 bootstrap-resamples 20% of the campaign's sample
     plane first ("the sensor stream moved"), then repeats the loop.

Every step lands in the decision journal, so re-running this script on
the same out_dir resumes instead of redeciding.  The same loop is a CLI:

    PYTHONPATH=src python -m repro_torch.autopilot run \
        --emit-dir artifacts --tenant tnn_breast_cancer \
        --dataset breast_cancer --rounds 2

The port of `examples/autopilot_loop.py`: training, the campaign and the
fleet run on `--device` (default: the current CUDA device; `cpu` runs the
plain PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/autopilot_loop.py [out_dir]
          [--device cpu]
"""
import argparse
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.autopilot import (Autopilot, AutopilotConfig,
                                   CampaignSource, DecisionJournal,
                                   PromotionPolicy, dataset_traffic)
from repro_torch.compile import write_artifacts
from repro_torch.core import tnn as T
from repro_torch.data.tabular import make_dataset
from repro_torch.evolve.campaign import Campaign
from repro_torch.evolve.config import CampaignConfig
from repro_torch.evolve.problems import attach_tnn_drift, build_tnn_problem
from repro_torch.serve import ClassifierFleet

DATASET = "breast_cancer"


def seed_incumbent(out: Path, device) -> None:
    """Emit a quick exact-TNN tenant as the fleet's starting incumbent."""
    from repro_torch.compile import lower_classifier

    ds = make_dataset(DATASET)
    tnn = T.train_tnn(ds, T.TNNTrainConfig(
        n_hidden=ds.spec.topology[1], epochs=6, lr=1e-2), device=device)
    cc = lower_classifier(tnn, *T.exact_netlists(tnn))
    paths = write_artifacts(cc, out, base=f"tnn_{DATASET}", dataset=DATASET)
    print(f"incumbent emitted (acc={tnn.test_acc:.3f}) -> "
          f"{paths['manifest']}")


def main(out_dir: str = "artifacts_autopilot", device=None) -> None:
    dev = resolve_device(device)
    out = Path(out_dir)
    if not (out / "fleet.json").exists():
        seed_incumbent(out, dev)

    problem = build_tnn_problem(DATASET, epochs=6, cgp_points=2,
                                cgp_iters=120, pcc_samples=4000, device=dev)
    attach_tnn_drift(problem, rate=0.2)          # rounds re-sample 20%
    campaign = Campaign(problem.domains, problem.objective,
                        CampaignConfig(n_islands=2, pop_size=12, n_epochs=3,
                                       gens_per_epoch=2, device=str(dev)),
                        checkpoint_dir=str(out / "autopilot_ckpt"),
                        seed_population=problem.seed_population,
                        name=problem.name)
    source = CampaignSource(problem, campaign, require_improvement=False)

    cfg = AutopilotConfig(
        tenant=f"tnn_{DATASET}", rounds=3, mirror_pairs=64,
        policy=PromotionPolicy(min_pairs=48, min_truth=32),
        sabotage_rounds=frozenset({0}))          # round 0: rollback drill
    with ClassifierFleet.from_emit_dir(out, device=dev) as fleet:
        pilot = Autopilot(
            fleet, source, dataset_traffic(DATASET, batch=32),
            DecisionJournal(out / "autopilot_journal.jsonl"), cfg,
            on_event=lambda ev: print(
                f"  [round {ev.get('round', '-')}] {ev['event']}"
                + (f" -> {ev['action']}: {ev['reason']}"
                   if ev["event"] == "decision" else "")))
        outcomes = pilot.run()
        stats = fleet.stats_summary()

    print(f"\noutcomes: {[o['event'] for o in outcomes]}")
    print(f"manifest generation: {stats['manifest_generation']}")
    alpha = stats["tenants"][f"tnn_{DATASET}"]
    print(f"live tenant sha256: {alpha['sha256'][:12]}…  "
          f"({alpha['n_requests']} requests served, "
          f"{alpha['n_slo_miss']} SLO misses)")
    assert outcomes[0]["event"] == "rolled_back"     # the drill rolled back
    print("journal:", out / "autopilot_journal.jsonl")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="artifacts_autopilot")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current CUDA device) or cpu")
    a = ap.parse_args()
    main(a.out_dir, a.device)
