"""What every cell shares: finding its files, checking the device, the
run's record, the metric readers and the result line.

A run prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`),
`device`, with `--trace 1` a `breakdown`, and last `checks`: each number
the correctness check compared, with its limit.  The same numbers end
standard error.  Which metrics a cell reports is read from
`BENCHMARK.json`; each is computed by `metrics/<name>.py`'s `read(run)`,
which returns None when it finds nothing to read.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench_dir: Path = BENCH) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic mix) of cell `name`."""
    cell = load_json(bench_dir / "cells" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in bench['workloads']]}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of `cell` reports: end-to-end ones with
    `trace` off, per-layer ones with it on."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, bench_dir: Path = BENCH):
    """`read(run)` of `metrics/<name>.py`."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Run:
    """One run's record, which the metric readers read."""
    config: dict
    mix: dict
    setup_s: float = math.nan
    window_s: float = math.nan
    peak_bytes: int = 0              # the window's allocator peak
    memory_peak_bytes: int = 0       # the process's, before the check
    device_name: str = ""
    device_count: int = 0
    attempted: int = 0
    failed: int = 0
    work: dict = field(default_factory=dict)     # the driver's counts
    trace: object = None                         # devtrace.Trace, traced runs
    checks: dict = field(default_factory=dict)   # name -> (value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


@dataclass
class Ctx:
    """What a driver is given."""
    cell: str
    cell_spec: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                        # the process clock at start


def card_limits() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(run: Run, entries: list[dict]) -> dict:
    metrics = {}
    for m in entries:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_name,
              "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None, t0: float | None = None) -> int:
    import time
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    bench = benchmark()
    wl = workload(bench, args.workload)
    cell, config, mix = cell_files(args.workload)
    import torch
    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        say(f"{args.workload} needs {wl['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    dev = torch.device("cuda", 0)
    ctx = Ctx(args.workload, cell, config, mix, args.seed, args.seconds,
              bool(args.trace), dev, t0)
    run = driver(mix["kind"]).run(ctx)
    run.device_name = torch.cuda.get_device_name(dev)
    run.device_count = wl["chips"]
    bad = forbidden_modules()
    if bad:
        say(f"forbidden modules loaded in the run's process: {bad}")
        return 3
    out = result(run, metrics_for(bench, args.workload, bool(args.trace)))
    say("card: " + card_limits())
    for k, c in out["checks"].items():
        say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
