"""Autopilot CLI — run / inspect / override the continuous-deployment loop.

The port of `python -m repro.autopilot`, with one `--device` in place of
`--serve-backend` and `--eval-backend`: the campaign and the fleet run on
the current CUDA device, and raise without one unless `--device cpu`
asks for the plain PyTorch versions.

    # seed an incumbent first (any emit works):
    PYTHONPATH=src python -m repro_torch.evolve --dataset breast_cancer \\
        --emit-dir runs/fleet --epochs 1 --islands 2 --pop 12

    # then let the autopilot keep improving + shadow-verifying it:
    PYTHONPATH=src python -m repro_torch.autopilot run --emit-dir runs/fleet \\
        --tenant tnn_breast_cancer --dataset breast_cancer --rounds 2

`run` drives the full loop in-process: campaign epochs against (optionally
drifting) data, candidate staging under ``<emit-dir>/candidates/``, shadow
deployment on mirrored live traffic, and journaled promote/rollback
decisions (``<emit-dir>/autopilot_journal.jsonl``).  `--port` additionally
serves the fleet over the wire protocol while the loop runs, so STATS /
LIST show the shadow and deploy identity live.  Re-running after a crash
resumes mid-rollout from the journal.  `status` summarizes the journal;
`promote`/`rollback` are operator overrides for a *stopped* controller.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.autopilot.controller import (Autopilot, AutopilotConfig,
                                              CampaignSource, PromotionPolicy,
                                              dataset_traffic)
from repro_torch.autopilot.journal import DecisionJournal
from repro_torch.compile import artifact as A
from repro_torch.serve.fleet import ClassifierFleet


def _parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.autopilot",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="drive the evolve→shadow→promote loop")
    run.add_argument("--emit-dir", required=True)
    run.add_argument("--tenant", required=True,
                     help="incumbent manifest tenant to keep improving")
    run.add_argument("--dataset", required=True,
                     help="dataset for the campaign + mirrored traffic")
    run.add_argument("--rounds", type=int, default=2)
    run.add_argument("--journal", default=None,
                     help="decision journal path (default: "
                          "<emit-dir>/autopilot_journal.jsonl)")
    run.add_argument("--out", default=None,
                     help="write a JSON report of round outcomes here")
    # serving
    run.add_argument("--device", default=None,
                     help="torch device of the fleet and the campaign "
                          "(default: the current CUDA device; 'cpu' runs "
                          "the plain PyTorch versions)")
    run.add_argument("--replicas", type=int, default=1)
    run.add_argument("--port", type=int, default=None,
                     help="also serve the fleet over TCP while running")
    run.add_argument("--shards", type=int, default=1)
    # mirrored-traffic verdict
    run.add_argument("--mirror-pairs", type=int, default=96)
    run.add_argument("--traffic-batch", type=int, default=32)
    run.add_argument("--verdict-timeout-s", type=float, default=120.0)
    run.add_argument("--min-pairs", type=int, default=64)
    run.add_argument("--min-agreement", type=float, default=0.98)
    run.add_argument("--min-truth", type=int, default=32)
    run.add_argument("--accuracy-margin", type=float, default=0.0)
    run.add_argument("--max-latency-factor", type=float, default=None)
    # campaign budgets (examples-scale defaults, cf. repro_torch.evolve)
    run.add_argument("--islands", type=int, default=2)
    run.add_argument("--pop", type=int, default=12)
    run.add_argument("--gens-per-epoch", type=int, default=2)
    run.add_argument("--epochs-per-round", type=int, default=1)
    run.add_argument("--migrate-k", type=int, default=2)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--tnn-epochs", type=int, default=8)
    run.add_argument("--cgp-iters", type=int, default=150)
    run.add_argument("--cgp-points", type=int, default=2)
    run.add_argument("--pcc-samples", type=int, default=6000)
    run.add_argument("--phase-cache", default=None,
                     help="Phase-1/2 product cache dir (default: "
                          "$REPRO_TORCH_PHASE_CACHE or ~/.cache/"
                          "repro_torch/phase_cache); restarted controllers "
                          "skip the TNN/CGP/PCC rebuild entirely")
    run.add_argument("--drift-rate", type=float, default=0.0,
                     help="fraction of the objective's sample plane "
                          "bootstrap-resampled each round (0 = static data)")
    run.add_argument("--no-require-improvement", action="store_true",
                     help="shadow-verify every round's winner even when the "
                          "campaign objective did not improve")
    # drills / debug
    run.add_argument("--sabotage-round", type=int, action="append",
                     default=[],
                     help="deliberately break this round's candidate "
                          "(rollback drill; repeatable)")
    run.add_argument("--kill-after", default=None, metavar="STAGE:ROUND",
                     help="debug: SIGKILL self right after journaling this "
                          "stage (candidate|shadow|verdict|decision)")

    st = sub.add_parser("status", help="summarize the decision journal")
    st.add_argument("--emit-dir", required=True)
    st.add_argument("--journal", default=None)
    st.add_argument("--json", action="store_true")

    pr = sub.add_parser("promote", help="operator override: promote a "
                                        "staged candidate (stopped "
                                        "controller only)")
    pr.add_argument("--emit-dir", required=True)
    pr.add_argument("--journal", default=None)
    pr.add_argument("--round", type=int, required=True)

    rb = sub.add_parser("rollback", help="operator override: close an open "
                                         "round as rolled back")
    rb.add_argument("--emit-dir", required=True)
    rb.add_argument("--journal", default=None)
    rb.add_argument("--round", type=int, required=True)
    return ap.parse_args(argv)


def _journal_for(args) -> DecisionJournal:
    path = args.journal or (Path(args.emit_dir) / "autopilot_journal.jsonl")
    return DecisionJournal(path)


def _baseline_obj(emit_dir: Path, tenant: str) -> float | None:
    """Incumbent's recorded objective-0 (campaign provenance), if any."""
    try:
        rows = {r["name"]: r for r in A.load_manifest(emit_dir)}
        objectives = rows[tenant].get("provenance", {}).get("objectives")
        return float(objectives[0]) if objectives else None
    except (FileNotFoundError, KeyError, TypeError, ValueError):
        return None


def _cmd_run(args) -> int:
    from repro_torch.evolve.campaign import Campaign
    from repro_torch.evolve.config import CampaignConfig
    from repro_torch.evolve.problems import (attach_tnn_drift,
                                             build_tnn_problem)

    emit_dir = Path(args.emit_dir)
    journal = _journal_for(args)
    kill_after = None
    if args.kill_after:
        stage, _, rnd = args.kill_after.partition(":")
        kill_after = (stage, int(rnd))

    problem = build_tnn_problem(args.dataset, seed=args.seed,
                                epochs=args.tnn_epochs,
                                cgp_points=args.cgp_points,
                                cgp_iters=args.cgp_iters,
                                pcc_samples=args.pcc_samples,
                                device=args.device,
                                cache_dir=args.phase_cache)
    if args.drift_rate > 0.0:
        attach_tnn_drift(problem, args.drift_rate, seed=args.seed)
    cfg = CampaignConfig(n_islands=args.islands, pop_size=args.pop,
                         n_epochs=args.rounds * args.epochs_per_round,
                         gens_per_epoch=args.gens_per_epoch,
                         migrate_k=args.migrate_k, seed=args.seed,
                         device=args.device)
    campaign = Campaign(problem.domains, problem.objective, cfg,
                        checkpoint_dir=str(emit_dir / "autopilot_ckpt"
                                           / args.tenant),
                        seed_population=problem.seed_population,
                        name=problem.name)
    source = CampaignSource(
        problem, campaign, epochs_per_round=args.epochs_per_round,
        baseline_obj=_baseline_obj(emit_dir, args.tenant),
        require_improvement=not args.no_require_improvement)

    policy = PromotionPolicy(
        min_pairs=args.min_pairs, min_agreement=args.min_agreement,
        min_truth=args.min_truth, accuracy_margin=args.accuracy_margin,
        max_latency_factor=args.max_latency_factor)
    cfg_ap = AutopilotConfig(
        tenant=args.tenant, rounds=args.rounds,
        mirror_pairs=args.mirror_pairs, traffic_batch=args.traffic_batch,
        verdict_timeout_s=args.verdict_timeout_s,
        shadow_replicas=args.replicas, policy=policy,
        sabotage_rounds=frozenset(args.sabotage_round),
        kill_after=kill_after)

    server = None
    fleet = ClassifierFleet.from_emit_dir(
        emit_dir, device=args.device, replicas=args.replicas)
    try:
        if args.port is not None:
            from repro_torch.serve.server import FleetServer
            server = FleetServer(fleet, port=args.port, shards=args.shards)
            host, port = server.start_background()
            print(f"autopilot: fleet served on {host}:{port} "
                  f"({args.shards} shard(s))", flush=True)
        traffic = dataset_traffic(args.dataset, batch=args.traffic_batch,
                                  seed=args.seed)
        pilot = Autopilot(
            fleet, source, traffic, journal, cfg_ap,
            on_event=lambda ev: print(
                f"autopilot: [round {ev.get('round', '-')}] {ev['event']}"
                + (f" -> {ev['action']} ({ev['reason']})"
                   if ev["event"] == "decision" else ""), flush=True))
        outcomes = pilot.run()
        generation = int(A.load_manifest_doc(emit_dir)["generation"])
        n_promoted = sum(o["event"] == "promoted" for o in outcomes)
        print(f"autopilot: {len(outcomes)} round(s) decided, "
              f"{n_promoted} promoted; manifest generation {generation}",
              flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"tenant": args.tenant, "rounds": args.rounds,
                 "outcomes": outcomes, "generation": generation},
                indent=2, sort_keys=True) + "\n")
            print(f"wrote {args.out}", flush=True)
    finally:
        if server is not None:
            server.stop()
        fleet.shutdown(drain=False)
    return 0


def _round_states(journal: DecisionJournal) -> dict[int, dict]:
    states = {}
    for r, events in sorted(journal.rounds().items()):
        latest = events[-1]
        state = {"stage": latest["event"]}
        for ev in events:
            if ev["event"] == "candidate":
                state["candidate"] = ev["name"]
                state["sha256"] = ev["sha256"]
            elif ev["event"] == "decision":
                state["action"] = ev["action"]
                state["reason"] = ev["reason"]
            elif ev["event"] == "promoted":
                state["generation"] = ev["generation"]
        states[r] = state
    return states


def _cmd_status(args) -> int:
    journal = _journal_for(args)
    states = _round_states(journal)
    try:
        generation = int(A.load_manifest_doc(args.emit_dir)["generation"])
    except FileNotFoundError:
        generation = None
    if args.json:
        print(json.dumps({"generation": generation,
                          "rounds": {str(r): s for r, s in states.items()}},
                         indent=2, sort_keys=True))
        return 0
    print(f"manifest generation: {generation}")
    if not states:
        print("journal: no rounds recorded")
    for r, s in states.items():
        line = f"round {r}: {s['stage']}"
        if "candidate" in s:
            line += f"  candidate={s['candidate']}"
        if "action" in s:
            line += f"  action={s['action']} ({s['reason']})"
        if "generation" in s:
            line += f"  generation={s['generation']}"
        print(line)
    return 0


def _open_round(journal: DecisionJournal, r: int) -> dict:
    events = journal.rounds().get(r)
    if not events:
        raise SystemExit(f"round {r} has no journal entries")
    by_event = {ev["event"]: ev for ev in events}
    for terminal in ("promoted", "rolled_back", "held", "no_candidate"):
        if terminal in by_event:
            raise SystemExit(f"round {r} already closed: {terminal}")
    if "candidate" not in by_event:
        raise SystemExit(f"round {r} has no staged candidate")
    return by_event["candidate"]


def _cmd_promote(args) -> int:
    emit_dir = Path(args.emit_dir)
    journal = _journal_for(args)
    cand = _open_round(journal, args.round)
    tenant = cand["name"].rsplit("__cand_r", 1)[0]
    rows = {r["name"]: r for r in A.load_manifest(emit_dir)}
    incumbent = rows.get(tenant, {})
    A.register_tenant(emit_dir, {
        "name": tenant,
        "program": str(emit_dir / cand["program"]),
        "dataset": cand.get("dataset") or incumbent.get("dataset"),
        "n_features": cand["n_features"],
        "n_classes": cand["n_classes"],
        "replicas": incumbent.get("replicas", 1),
        "sha256": cand["sha256"],
        "provenance": dict(cand.get("provenance", {})),
    })
    generation = int(A.load_manifest_doc(emit_dir)["generation"])
    journal.append("promoted", round=args.round, candidate=cand["name"],
                   sha256=cand["sha256"], generation=generation,
                   operator=True)
    print(f"promoted {cand['name']} -> tenant {tenant!r} "
          f"(manifest generation {generation}); watching fleets pick it up "
          "on their next sync")
    return 0


def _cmd_rollback(args) -> int:
    journal = _journal_for(args)
    cand = _open_round(journal, args.round)
    journal.append("rolled_back", round=args.round, candidate=cand["name"],
                   reason="operator rollback", operator=True)
    print(f"rolled back round {args.round} ({cand['name']}); the incumbent "
          "row is untouched")
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    return {"run": _cmd_run, "status": _cmd_status,
            "promote": _cmd_promote, "rollback": _cmd_rollback}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
