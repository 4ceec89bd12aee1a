"""Campaign CLI — run / resume island-model evolution searches.

The port of `python -m repro.evolve`, with `--device` in place of
`--backend`: the problem is built and scored on the current CUDA device,
and raises without one unless `--device cpu` asks for the plain PyTorch
versions.

    PYTHONPATH=src python -m repro_torch.evolve --problem tnn \
        --dataset cardio --islands 4 --epochs 8 --ckpt-dir runs/cardio \
        --out front_cardio.json [--device cpu]

Re-running the same command against an existing `--ckpt-dir` resumes from
the newest valid snapshot (use `--fresh` to wipe and restart).  `--dataset
all` sweeps every Table-2 dataset into per-dataset checkpoint subdirs.
`--emit-dir` lowers the best-accuracy archive entry of a TNN campaign
through repro_torch.compile and writes Verilog + EGFET report artifacts
plus a fleet manifest row.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import numpy as np

from repro_torch.data.tabular import DATASETS
from repro_torch.evolve.campaign import Campaign
from repro_torch.evolve.config import CampaignConfig
from repro_torch.evolve.problems import (ProblemSpec, build_problem,
                                         compile_archive_winner)


def _parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.evolve",
                                 description=__doc__)
    ap.add_argument("--problem", choices=("tnn", "synth"), default="tnn")
    ap.add_argument("--dataset", default="cardio",
                    help=f"one of {', '.join(DATASETS)}, or 'all'")
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--pop", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--gens-per-epoch", type=int, default=5)
    ap.add_argument("--migrate-k", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the fitness (default: the "
                         "current CUDA device; 'cpu' runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--workers", type=int, default=0,
                    help="island-executor process count (0/1 = serial; "
                         "N>1 steps islands concurrently, bit-identical)")
    ap.add_argument("--phase-cache", default=None,
                    help="Phase-1/2 product cache dir (default: "
                         "$REPRO_TORCH_PHASE_CACHE or "
                         "~/.cache/repro_torch/phase_cache; set the env to "
                         "'off' to disable)")
    ap.add_argument("--phase-key", default=None,
                    help="TNN only: load the phase-cache entry of this key "
                         "(one the reference wrote, say) instead of the "
                         "port's own; never recomputed")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (resume happens automatically)")
    ap.add_argument("--fresh", action="store_true",
                    help="delete existing checkpoints before running")
    ap.add_argument("--out", default=None,
                    help="write the final Pareto archive as JSON here")
    ap.add_argument("--emit-dir", default=None,
                    help="TNN only: write winner RTL + EGFET report here")
    # TNN problem budgets (examples-scale defaults)
    ap.add_argument("--tnn-epochs", type=int, default=12)
    ap.add_argument("--cgp-iters", type=int, default=500)
    ap.add_argument("--cgp-points", type=int, default=3)
    ap.add_argument("--pcc-samples", type=int, default=30000)
    # synth problem shape
    ap.add_argument("--genes", type=int, default=10)
    ap.add_argument("--domain", type=int, default=6)
    ap.add_argument("--kill-after-epoch", type=int, default=None,
                    help="debug: SIGKILL self right after this epoch's "
                         "checkpoint (resume-test harness)")
    return ap.parse_args(argv)


def _run_one(args: argparse.Namespace, dataset: str | None) -> dict:
    if args.problem == "synth":
        spec = ProblemSpec("synth", {"n_genes": args.genes,
                                     "domain": args.domain})
    else:
        spec = ProblemSpec("tnn", {"dataset": dataset, "seed": args.seed,
                                   "epochs": args.tnn_epochs,
                                   "cgp_points": args.cgp_points,
                                   "cgp_iters": args.cgp_iters,
                                   "pcc_samples": args.pcc_samples,
                                   "device": args.device,
                                   "cache_dir": args.phase_cache,
                                   "phase_key": args.phase_key})
    problem = build_problem(spec)
    cfg = CampaignConfig(n_islands=args.islands, pop_size=args.pop,
                         n_epochs=args.epochs,
                         gens_per_epoch=args.gens_per_epoch,
                         migrate_k=args.migrate_k, seed=args.seed,
                         device=args.device, workers=args.workers)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir and dataset and args.dataset == "all":
        ckpt_dir = str(Path(ckpt_dir) / dataset)
    if ckpt_dir and args.fresh:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    campaign = Campaign(problem.domains, problem.objective, cfg,
                        checkpoint_dir=ckpt_dir,
                        seed_population=problem.seed_population,
                        name=problem.name, problem_spec=spec)

    def on_epoch(epoch: int, c: Campaign) -> None:
        best = c.archive.F[:, 0].min() if len(c.archive) else float("nan")
        print(f"[{problem.name}] epoch {epoch + 1}/{cfg.n_epochs}: "
              f"archive {len(c.archive)} designs, best obj0 {best:.4f}",
              flush=True)

    t0 = time.perf_counter()
    try:
        res = campaign.run(on_epoch=on_epoch,
                           kill_after_epoch=args.kill_after_epoch)
    finally:
        campaign.close()
    dt = time.perf_counter() - t0
    if res.resumed_from is not None:
        print(f"[{problem.name}] resumed from epoch {res.resumed_from} "
              f"checkpoint ({res.epochs_run} epochs this process)")
    print(f"[{problem.name}] archive: {len(res.archive_x)} Pareto designs "
          f"in {dt:.1f}s")

    payload = {
        "problem": problem.name,
        "config": {"islands": cfg.n_islands, "pop": cfg.pop_size,
                   "epochs": cfg.n_epochs,
                   "gens_per_epoch": cfg.gens_per_epoch,
                   "migrate_k": cfg.migrate_k, "seed": cfg.seed,
                   "device": cfg.device, "workers": cfg.workers},
        "resumed_from": res.resumed_from,
        "cache": res.cache_history[-1] if res.cache_history else None,
        "archive": [{"x": x.tolist(), "f": [float(a), float(b)]}
                    for x, (a, b) in zip(res.archive_x, res.archive_f)],
    }
    if args.emit_dir and problem.approx is not None and len(res.archive_x):
        from repro_torch.compile import egfet_report, write_artifacts
        best_i = int(np.argmin(res.archive_f[:, 0]))
        best_x = res.archive_x[best_i]
        cc = compile_archive_winner(problem, best_x)
        provenance = {
            "seed": cfg.seed,
            "islands": cfg.n_islands,
            "pop_size": cfg.pop_size,
            "generations": campaign.next_epoch * cfg.gens_per_epoch,
            "objectives": [float(v) for v in res.archive_f[best_i]],
            "config_fingerprint": campaign.fingerprint(),
            "device": str(problem.approx.device),
            "resumed_from": res.resumed_from,
        }
        paths = write_artifacts(cc, args.emit_dir, base=problem.name,
                                dataset=dataset, provenance=provenance)
        payload["artifacts"] = paths
        rep = egfet_report(cc)
        print(f"[{problem.name}] emitted winner: {cc.ir.n_gates} gates, "
              f"{rep['total_area_mm2']:.2f} mm^2 -> {paths['verilog']}")
        print(f"[{problem.name}] fleet tenant registered in "
              f"{paths['manifest']} (python -m repro_torch.serve --emit-dir "
              f"{args.emit_dir})")
    return payload


def main(argv=None) -> None:
    args = _parse_args(argv)
    datasets = (sorted(DATASETS) if args.dataset == "all"
                else [args.dataset])
    if args.problem == "tnn":
        unknown = [d for d in datasets if d not in DATASETS]
        if unknown:
            raise SystemExit(f"unknown dataset(s): {', '.join(unknown)}; "
                             f"valid: {', '.join(sorted(DATASETS))}, all")
    else:
        datasets = [None]
    payloads = [_run_one(args, d) for d in datasets]
    if args.out:
        out = payloads[0] if len(payloads) == 1 else {"campaigns": payloads}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2, sort_keys=True)
                                  + "\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
