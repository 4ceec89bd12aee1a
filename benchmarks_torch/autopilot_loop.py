"""Autopilot loop economics: mirror tax + time-to-first-promotion.

The port of `benchmarks/autopilot_loop.py`, on `device` (None: the current
CUDA device).  The rows' ``backend`` key of the reference is ``device``
here; every other key is the reference's.

Overhead section (`bench == "autopilot_overhead"`): one breast_cancer
exact-TNN tenant on `device` replays a held-out stream through
`submit_many` twice — once bare, once with a byte-identical shadow
deployed so every admitted request is mirrored — and reports incumbent
readings/s and request p50/p99 for both, plus a `mirror_tax` row with the
throughput/latency ratios: what mirroring costs the primary path.

Promotion section (`bench == "autopilot_promotion"`): one full controller
round against a live fleet — stage the candidate bundle, shadow-deploy,
mirror labeled pairs until the policy floor, decide, atomic manifest
swap — timed from `Autopilot.run()` entry to the journaled `promoted`
event, with the per-stage breakdown recovered from the decision
journal's own timestamps.

Run directly to write the artifact (never the reference's
`BENCH_autopilot.json`):

    PYTHONPATH=src python -m benchmarks_torch.autopilot_loop \
        [build/BENCH_autopilot_torch.json] [--device cpu]
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.autopilot import (Autopilot, AutopilotConfig, Candidate,
                             DecisionJournal, PromotionPolicy,
                             ScriptedSource, dataset_traffic)
from repro_torch.compile import write_artifacts
from repro_torch.compile.ir import lower_classifier
from repro_torch.core.tnn import exact_netlists
from repro_torch.serve import ClassifierFleet
from benchmarks_torch.common import QUICK, get_trained_tnn

OUT_PATH = "build/BENCH_autopilot_torch.json"

DATASET = "breast_cancer"
N_READINGS = 4096 if QUICK else 65_536
REPLAY_BATCH = 64
DEADLINE_MS = 1000.0        # generous: the bench measures tax, not misses
MIRROR_PAIRS = 96 if QUICK else 512


def _emit_incumbent(out: Path, device):
    ds, tnn = get_trained_tnn(DATASET, device=device)
    cc = lower_classifier(tnn, *exact_netlists(tnn))
    write_artifacts(cc, out, base=f"tnn_{DATASET}", dataset=DATASET)
    return ds, cc


def _replay(fleet: ClassifierFleet, name: str, x_test: np.ndarray,
            n: int) -> dict:
    idx = np.random.default_rng(0).integers(0, x_test.shape[0], size=n)
    stream = x_test[idx]
    t0 = time.perf_counter()
    reqs = []
    for lo in range(0, n, REPLAY_BATCH):
        batch, _, _ = fleet.submit_many(name, stream[lo:lo + REPLAY_BATCH])
        reqs.extend(batch)
    fleet.flush()
    for r in reqs:
        r.result(30.0)
    elapsed = time.perf_counter() - t0
    t = fleet.stats_summary()["tenants"][name]
    return {"readings": n, "readings_per_s": n / elapsed,
            "req_p50_ms": t["req_p50_ms"], "req_p99_ms": t["req_p99_ms"],
            "n_slo_miss": t["n_slo_miss"]}


def _overhead_rows(device) -> list[dict]:
    from repro_torch.compile.program import CircuitProgram
    from repro_torch.serve import TenantSpec

    rows = []
    with tempfile.TemporaryDirectory() as td:
        ds, cc = _emit_incumbent(Path(td), device)
        name = f"tnn_{DATASET}"
        kw = dict(device=device, deadline_ms=DEADLINE_MS)
        with ClassifierFleet.from_emit_dir(td, **kw) as fleet:
            bare = _replay(fleet, name, ds.x_test, N_READINGS)
        with ClassifierFleet.from_emit_dir(td, **kw) as fleet:
            comp = fleet.deploy_shadow(TenantSpec(
                name=f"{name}!shadow", device=device,
                program=CircuitProgram.from_classifier(cc, device=device),
                deadline_ms=DEADLINE_MS), name)
            mirrored = _replay(fleet, name, ds.x_test, N_READINGS)
            s = fleet.retire_shadow(name)
        assert s["n_primary_errors"] == 0 and s["n_shadow_errors"] == 0
        rows.append({"bench": "autopilot_overhead", "mode": "bare",
                     "device": str(device), **bare})
        rows.append({"bench": "autopilot_overhead", "mode": "mirrored",
                     "device": str(device), **mirrored,
                     "n_mirrored": s["n_mirrored"],
                     "n_dropped": s["n_dropped"],
                     "agreement": s["agreement"]})
        rows.append({"bench": "autopilot_overhead", "mode": "mirror_tax",
                     "throughput_ratio":
                         mirrored["readings_per_s"] / bare["readings_per_s"],
                     "p50_ratio":
                         mirrored["req_p50_ms"] / max(bare["req_p50_ms"],
                                                      1e-9)})
    return rows


def _promotion_rows(device) -> list[dict]:
    rows = []
    with tempfile.TemporaryDirectory() as td:
        out = Path(td)
        _, cc = _emit_incumbent(out, device)
        name = f"tnn_{DATASET}"
        # A byte-identical candidate: equal accuracy on mirrored truth, so
        # the policy promotes — the bench times the machinery (staging,
        # shadow warmup, mirrored verdict, manifest swap), not the search.
        source = ScriptedSource([Candidate(
            cc=cc, objectives=[0.0, 0.0], provenance={"bench": True},
            dataset=DATASET)])
        journal = DecisionJournal(out / "autopilot_journal.jsonl")
        cfg = AutopilotConfig(
            tenant=name, rounds=1, mirror_pairs=MIRROR_PAIRS,
            policy=PromotionPolicy(min_pairs=min(64, MIRROR_PAIRS),
                                   min_truth=32))
        with ClassifierFleet.from_emit_dir(
                out, device=device, deadline_ms=DEADLINE_MS) as fleet:
            t0 = time.perf_counter()
            outcomes = Autopilot(fleet, source,
                                 dataset_traffic(DATASET, batch=32),
                                 journal, cfg).run()
            elapsed = time.perf_counter() - t0
            gen = fleet.stats_summary()["manifest_generation"]
        assert outcomes[0]["event"] == "promoted", outcomes
        ev = {e["event"]: e["t"] for e in journal.replay()}
        rows.append({
            "bench": "autopilot_promotion",
            "mirror_pairs": MIRROR_PAIRS,
            "time_to_first_promotion_s": elapsed,
            "shadow_deploy_s": ev["shadow_deployed"] - ev["candidate"],
            "shadow_verdict_s": ev["verdict"] - ev["shadow_deployed"],
            "execute_s": ev["promoted"] - ev["decision"],
            "manifest_generation": gen,
        })
    return rows


def run(device=None) -> list[dict]:
    dev = resolve_device(device)
    return _overhead_rows(dev) + _promotion_rows(dev)


def main(out_path: str = OUT_PATH, device=None) -> None:
    dev = resolve_device(device)
    rows = run(device=dev)
    for r in rows:
        print(json.dumps(r))
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"dataset": DATASET, "quick": QUICK, "device": str(dev),
                   "rows": rows}, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    from benchmarks_torch.cgp_throughput import _cli
    main(*_cli(sys.argv[1:]))
