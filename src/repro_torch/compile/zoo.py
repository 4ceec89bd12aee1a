"""Zoo batch compiler — sweep campaigns into one servable model fleet.

The port of `repro.compile.zoo`, with `device` in place of `backend` in
each recipe.

Generator-style batch lowering: a grid of `ZooEntry` recipes (dataset x
variant x budgets) each runs the full producer pipeline — phase-cached
TNN/CGP/PCC products, a serial NSGA-II campaign, `compile_archive_winner`
on the archive's best-accuracy chromosome — and emits Verilog + EGFET
report + servable program bundle into one shared emit directory whose
``fleet.json`` indexes every tenant.  The point is scale-testing the
serving side: a zoo directory is exactly what ``python -m repro_torch.serve
--emit-dir <zoo> --megakernel`` wants for multi-tenant megakernel
dispatch.

Incremental by construction: every manifest row is stamped with the
entry's content fingerprint (sha256 over the full recipe), and a rebuild
skips any entry whose row still matches *and* whose program bundle
verifies against the row's recorded sha256.  A stale fingerprint, a
missing bundle, or a corrupt one (checksum mismatch) rebuilds that entry
alone.  ``--force`` rebuilds everything.

Entries are independent, so the sweep fans out over a spawned worker
pool (``--workers``); on a card the parent builds the kernel library
before it spawns them, and each worker is one more CUDA context.  Workers compile and emit files only
(``write_artifacts(register=False)``): the ``fleet.json`` manifest is
read-modify-write, so the parent registers the returned rows serially —
no manifest races, deterministic generation numbering.

CLI:

    PYTHONPATH=src python -m repro_torch.compile.zoo \
        --datasets cardio redwine --variants base lean \
        --emit-dir zoo_out --workers 4 --out zoo_report.json [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path

# Bump when the campaign->compile->emit pipeline changes in a way that
# invalidates previously emitted zoo entries.
ZOO_VERSION = 1

# Variant presets: overrides applied to the CLI's base budgets.  Plain
# keys replace the value; ``<field>_scale`` keys multiply it (rounded,
# floored at 1) — so one ``--pop/--epochs`` baseline fans into a family
# of differently shaped searches.
VARIANTS: dict[str, dict] = {
    "base": {},
    "lean": {"pop_scale": 0.5, "gens_per_epoch_scale": 0.5},
    "wide": {"islands_scale": 2.0, "pop_scale": 1.5},
    "alt-seed": {"seed": 17},
}


@dataclass(frozen=True)
class ZooEntry:
    """One zoo recipe: everything its emitted artifact depends on."""

    dataset: str
    tag: str = "base"
    seed: int = 0
    # campaign budgets
    islands: int = 4
    pop: int = 24
    epochs: int = 8
    gens_per_epoch: int = 5
    migrate_k: int = 2
    # Phase-1/2 budgets (phase-cache key inputs)
    tnn_epochs: int = 12
    cgp_points: int = 3
    cgp_iters: int = 500
    pcc_samples: int = 30000
    device: str | None = None       # None: the current CUDA device
    replicas: int = 1

    @property
    def name(self) -> str:
        return f"tnn_{self.dataset}__{self.tag}"

    def fingerprint(self) -> str:
        """sha256 over the full recipe — the manifest skip key."""
        blob = json.dumps({"zoo_version": ZOO_VERSION, **asdict(self)},
                          sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()


def apply_variant(base: dict, overrides: dict) -> dict:
    out = dict(base)
    for k, v in overrides.items():
        if k.endswith("_scale"):
            f = k[: -len("_scale")]
            out[f] = max(1, int(round(out[f] * v)))
        else:
            out[k] = v
    return out


def make_entries(datasets: list[str], variants: list[str],
                 **base) -> list[ZooEntry]:
    """The dataset x variant grid over one set of base budgets."""
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variant(s) {', '.join(unknown)}; "
                         f"valid: {', '.join(sorted(VARIANTS))}")
    entries = []
    for ds in datasets:
        for tag in variants:
            kw = apply_variant(base, VARIANTS[tag])
            entries.append(ZooEntry(dataset=ds, tag=tag, **kw))
    return entries


def _compile_entry(entry_dict: dict, emit_dir: str,
                   cache_dir: str | None) -> dict:
    """Worker: campaign -> winner -> artifacts; returns the manifest row.

    Module-level (spawn-picklable).  Emits files only — the parent owns
    the manifest.  The Phase-1/2 half rides the content-addressed phase
    cache, so N entries over one dataset/budget pair train its TNN once.
    """
    from repro_torch.compile.verilog import write_artifacts
    from repro_torch.evolve.campaign import Campaign
    from repro_torch.evolve.config import CampaignConfig
    from repro_torch.evolve.problems import (ProblemSpec, build_problem,
                                             compile_archive_winner)

    entry = ZooEntry(**entry_dict)
    spec = ProblemSpec("tnn", {
        "dataset": entry.dataset, "seed": entry.seed,
        "epochs": entry.tnn_epochs, "cgp_points": entry.cgp_points,
        "cgp_iters": entry.cgp_iters, "pcc_samples": entry.pcc_samples,
        "device": entry.device, "cache_dir": cache_dir})
    problem = build_problem(spec)
    cfg = CampaignConfig(n_islands=entry.islands, pop_size=entry.pop,
                         n_epochs=entry.epochs,
                         gens_per_epoch=entry.gens_per_epoch,
                         migrate_k=entry.migrate_k, seed=entry.seed,
                         device=entry.device)
    campaign = Campaign(problem.domains, problem.objective, cfg,
                        seed_population=problem.seed_population,
                        name=entry.name)
    res = campaign.run()
    x, f = campaign.best_by_objective(0)
    cc = compile_archive_winner(problem, x)
    provenance = {
        "seed": cfg.seed, "islands": cfg.n_islands, "pop_size": cfg.pop_size,
        "generations": cfg.total_generations,
        "objectives": [float(v) for v in f],
        "config_fingerprint": campaign.fingerprint(),
        "device": str(problem.approx.device),
        "zoo_fingerprint": entry.fingerprint(),
        "zoo_tag": entry.tag,
        "archive_size": int(len(res.archive_x)),
    }
    paths = write_artifacts(cc, emit_dir, base=entry.name,
                            dataset=entry.dataset, replicas=entry.replicas,
                            provenance=provenance, register=False)
    return paths["entry"]


def _is_current(entry: ZooEntry, row: dict | None, emit_dir: Path) -> bool:
    """True iff `row` still vouches for `entry`: fingerprint match AND the
    bundle on disk verifies against the sha256 the row recorded."""
    from repro_torch.compile import artifact as A

    if row is None:
        return False
    if row.get("provenance", {}).get("zoo_fingerprint") != entry.fingerprint():
        return False
    try:
        A.verify_program_bundle(emit_dir / row["program"],
                                expect_sha256=row.get("sha256"))
    except (A.ArtifactCorruptError, FileNotFoundError, KeyError):
        return False
    return True


def build_zoo(entries: list[ZooEntry], emit_dir: str | Path,
              workers: int = 1, cache_dir: str | None = None,
              force: bool = False) -> dict:
    """Compile every stale entry, register all rows, return a report.

    Report: ``built`` / ``cached`` name lists, per-entry seconds, and the
    manifest path.  Raises on duplicate entry names (two recipes cannot
    share a tenant slot).
    """
    from repro_torch.compile import artifact as A

    emit_dir = Path(emit_dir)
    names = [e.name for e in entries]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate zoo entry names: {', '.join(sorted(dupes))}"
                         " — same dataset+tag twice in one sweep")
    try:
        rows = {r["name"]: r for r in A.load_manifest(emit_dir)}
    except FileNotFoundError:
        rows = {}

    cached = [] if force else [e for e in entries
                               if _is_current(e, rows.get(e.name), emit_dir)]
    cached_names = {e.name for e in cached}
    pending = [e for e in entries if e.name not in cached_names]

    t0 = time.perf_counter()
    built_rows: list[dict] = []
    if pending:
        if workers > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            from repro_torch.kernels import cuda_circuit_sim as CK

            CK.build_before_spawn([e.device for e in pending])
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(pending)),
                    mp_context=mp.get_context("spawn")) as pool:
                futs = [pool.submit(_compile_entry, asdict(e), str(emit_dir),
                                    cache_dir)
                        for e in pending]
                built_rows = [f.result() for f in futs]
        else:
            built_rows = [_compile_entry(asdict(e), str(emit_dir), cache_dir)
                          for e in pending]
    # manifest registration is read-modify-write: parent only, serial
    manifest = None
    for row in built_rows:
        manifest = A.register_tenant(emit_dir, row)
    if manifest is None:
        manifest = A.manifest_path(emit_dir)
    return {
        "entries": len(entries),
        "built": sorted(e.name for e in pending),
        "cached": sorted(e.name for e in cached),
        "build_s": round(time.perf_counter() - t0, 3),
        "workers": int(workers),
        "manifest": str(manifest),
    }


def _parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.data.tabular import DATASETS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.compile.zoo",
                                 description=__doc__)
    ap.add_argument("--datasets", nargs="+", default=["all"],
                    help=f"subset of {', '.join(sorted(DATASETS))}, or all")
    ap.add_argument("--variants", nargs="+", default=["base"],
                    help=f"subset of {', '.join(sorted(VARIANTS))}")
    ap.add_argument("--emit-dir", required=True)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--phase-cache", default=None,
                    help="Phase-1/2 product cache dir (default: "
                         "$REPRO_TORCH_PHASE_CACHE or "
                         "~/.cache/repro_torch/phase_cache)")
    ap.add_argument("--force", action="store_true",
                    help="rebuild every entry, cached or not")
    ap.add_argument("--out", default=None,
                    help="write the build report JSON here")
    # base budgets the variant presets scale from
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--pop", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--gens-per-epoch", type=int, default=5)
    ap.add_argument("--migrate-k", type=int, default=2)
    ap.add_argument("--tnn-epochs", type=int, default=12)
    ap.add_argument("--cgp-points", type=int, default=3)
    ap.add_argument("--cgp-iters", type=int, default=500)
    ap.add_argument("--pcc-samples", type=int, default=30000)
    ap.add_argument("--device", default=None,
                    help="torch device of every entry (default: the "
                         "current CUDA device; 'cpu' runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--replicas", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from repro_torch.data.tabular import DATASETS

    args = _parse_args(argv)
    datasets = (sorted(DATASETS) if args.datasets == ["all"]
                else args.datasets)
    unknown = [d for d in datasets if d not in DATASETS]
    if unknown:
        raise SystemExit(f"unknown dataset(s): {', '.join(unknown)}; "
                         f"valid: {', '.join(sorted(DATASETS))}, all")
    entries = make_entries(
        datasets, args.variants, seed=args.seed, islands=args.islands,
        pop=args.pop, epochs=args.epochs,
        gens_per_epoch=args.gens_per_epoch, migrate_k=args.migrate_k,
        tnn_epochs=args.tnn_epochs, cgp_points=args.cgp_points,
        cgp_iters=args.cgp_iters, pcc_samples=args.pcc_samples,
        device=args.device, replicas=args.replicas)
    print(f"[zoo] {len(entries)} entries "
          f"({len(datasets)} datasets x {len(args.variants)} variants) "
          f"-> {args.emit_dir} [workers={args.workers}]")
    report = build_zoo(entries, args.emit_dir, workers=args.workers,
                       cache_dir=args.phase_cache, force=args.force)
    print(f"[zoo] built {len(report['built'])}, "
          f"cached {len(report['cached'])} in {report['build_s']:.1f}s "
          f"-> {report['manifest']}")
    print(f"[zoo] serve it: python -m repro_torch.serve --emit-dir "
          f"{args.emit_dir} --megakernel")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2, sort_keys=True)
                                  + "\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
