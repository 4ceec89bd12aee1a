#!/usr/bin/env python3
"""One benchmark cell, traced, and what the program's own spans say of it.

    python3 tools/span_report.py --workload <cell> --seed <n> [--seconds 45]

Runs the cell on the first CUDA device as `bench/run.py --trace 1` does
(its driver, its window under the profiler, its check) and prints one
JSON line: the harness's result (per-layer metrics, `busy_s`,
`window_s`, the breakdown), the window's steps or cycles, and from the
program's spans (`repro_torch.trace`, read by `bench/spans.py`): each
span's count, device seconds and top kernels in the window, the share of the
window's kernel time launched inside the outermost spans (`train.step`,
`serve.group`), and the idle gaps by the innermost span at their
midpoint; for a program with `MOE_STATS`, its MoE calls, assignments,
dropped assignments and largest expert load over the mean.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, spans  # noqa: E402

OUTERMOST = ("train.step", "serve.group")
TOP = 8                  # kernels listed a span, by device time


def report(workload: str, seed: int, seconds: float) -> dict:
    import torch

    t0 = time.perf_counter()
    bench = harness.benchmark()
    wl = harness.workload(bench, workload)
    cell, config, mix = harness.cell_files(workload)
    ctx = harness.Ctx(workload, cell, config, mix, seed, seconds, True,
                      torch.device("cuda", 0), t0)
    run = harness.driver(mix["kind"]).run(ctx)
    run.device_name = torch.cuda.get_device_name(0)
    run.device_count = wl["chips"]
    out = harness.result(run, harness.metrics_for(bench, workload, True))
    out["card"] = harness.card_limits()
    out["work"] = {k: run.work[k] for k in ("steps", "cycles", "window_s")
                   if k in run.work}
    tr = run.trace
    kernel_s = float((tr.k_end - tr.k_start).sum()) * 1e-9
    sp = spans.program_spans(run) or {}
    out["kernel_s"] = kernel_s
    out["spans"] = {}
    for n, v in sorted(sp.items()):
        by = spans.kernels_in(run, [n])
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        out["spans"][n] = {"count": len(v), "device_s": sum(by.values()),
                           "kernels": [[k[:100], t] for k, t in top]}
    out["coverage"] = {n: out["spans"][n]["device_s"] / kernel_s
                       for n in OUTERMOST if n in sp}
    from repro_torch.models import moe
    if hasattr(moe, "MOE_STATS"):
        st = moe.MOE_STATS.summary()
        peak = st.pop("peak_load")
        out["moe_stats"] = dict(st, peak_load_mean=(
            sum(peak) / len(peak) if peak else None),
            peak_load_max=max(peak, default=None))
    out["idle_by_span"] = spans.idle_by_span(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    print(json.dumps(report(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
