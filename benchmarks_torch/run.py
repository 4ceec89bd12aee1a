"""Benchmark harness — one module per paper table/figure, on the port.

Prints ``name,us_per_call,derived`` CSV rows: `name` is bench/row id,
`us_per_call` the wall time of producing that row's experiment, `derived`
a compact JSON payload with the row's metrics.  The port of
`benchmarks/run.py`: every bench runs on `--device` (default: the current
CUDA device, which raises without one; `cpu` runs the plain PyTorch
versions).  `roofline` reads `reports/dryrun_torch.jsonl`, the records
`python -m repro_torch.launch.dryrun` writes (a row saying so when it is
missing), and runs nothing on the device.  On the card, the gate walk's
launches in this process (by kernel and by design; spawned workers count
their own) go to standard error as one JSON line at the end.

Env: REPRO_BENCH_FULL=1 switches from quick budgets to paper-scale budgets.
Usage: PYTHONPATH=src python -m benchmarks_torch.run [--only table2,fig4,...]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

BENCH_MODULES = {
    "table2": "benchmarks_torch.table2_accuracy",
    "fig4": "benchmarks_torch.fig4_pc_pareto",
    "fig5": "benchmarks_torch.fig5_pcc_pareto",
    "fig6": "benchmarks_torch.fig6_area_estimate",
    "fig7": "benchmarks_torch.fig7_tnn_pareto",
    "fig8": "benchmarks_torch.fig8_nsga2",
    "table3": "benchmarks_torch.table3_sota",
    "variation": "benchmarks_torch.variation_robustness",
    "roofline": "benchmarks_torch.roofline_bench",
    "cgp": "benchmarks_torch.cgp_throughput",
    "serve": "benchmarks_torch.serve_throughput",
    "evolve": "benchmarks_torch.evolve_campaign",
    "autopilot": "benchmarks_torch.autopilot_loop",
}
BENCHES = list(BENCH_MODULES)


def _load(name: str):
    import importlib
    return importlib.import_module(BENCH_MODULES[name])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(BENCHES))
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current CUDA device) or cpu")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.only.split(",")] if args.only else BENCHES
    unknown = [n for n in names if n not in BENCH_MODULES]
    if unknown:
        raise SystemExit(
            f"unknown bench name(s) {', '.join(unknown)}; "
            f"valid: {', '.join(BENCHES)}")
    from repro_torch import resolve_device
    device = resolve_device(args.device)

    print("name,us_per_call,derived")
    failures = 0
    for name in names:
        t0 = time.perf_counter()
        try:
            rows = _load(name).run(device=device)
            us = (time.perf_counter() - t0) * 1e6
            per_row = us / max(len(rows), 1)
            for row in rows:
                rid = row.pop("bench", name)
                extra = {k: v for k, v in row.items()}
                print(f"{rid},{per_row:.0f},{json.dumps(extra)}", flush=True)
        except Exception as e:   # noqa: BLE001 — benches report and continue
            failures += 1
            us = (time.perf_counter() - t0) * 1e6
            print(f"{name},{us:.0f},{json.dumps({'error': str(e)[:200]})}",
                  flush=True)
            import traceback
            traceback.print_exc(file=sys.stderr)
    if device.type == "cuda":
        from repro_torch.kernels import cuda_circuit_sim as CK
        print(json.dumps({"launches": CK.LAUNCHES,
                          "launches_by_design": CK.VARIANT_LAUNCHES}),
              file=sys.stderr)
    if failures:
        raise SystemExit(f"{failures} benchmark groups failed")


if __name__ == "__main__":
    main()
