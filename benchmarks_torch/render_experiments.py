"""Render the dry-run and roofline markdown tables from the port's
dry-run records (`reports/dryrun_torch.jsonl`).

The port of `benchmarks/render_experiments.py`, for one H100: the
reference's per-device terms of a 256-chip mesh become one card's, the
collective column is 0, the "fits" column reads the card's capacity from
each record (`torch.cuda.get_device_properties`, or `kernel_model`'s 80
GB with `--device cpu`), and the dry-run table lists the hand-written
kernels' calls where the reference listed collectives.  Every time in
the tables is analytic (a meta trace priced at `kernel_model`'s peaks).

Usage: PYTHONPATH=src python -m benchmarks_torch.render_experiments [path]
"""
from __future__ import annotations

import json
import sys

from benchmarks_torch.roofline_bench import PATH


def load(path: str) -> dict:
    best = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["arch"], rec["shape"], rec["mesh"],
                   rec.get("quant", "dense"), rec.get("remat", True),
                   rec.get("accum_dtype", "float32"),
                   rec.get("moe_fsdp", "d"), rec.get("microbatches"))
            best[key] = rec
    return best


def baseline_only(best: dict) -> list[dict]:
    """Default-knob records only (the baseline table)."""
    out = {}
    for (arch, shape, mesh, quant, remat, acc, mf, mb), rec in best.items():
        if quant == "dense" and remat and acc == "float32" and mf == "d":
            out[(arch, shape, mesh)] = rec
    return [out[k] for k in sorted(out)]


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def main(path: str = PATH) -> None:
    rows = baseline_only(load(path))
    devices = sorted({r["device"] for r in rows if "device" in r})

    print("### Dry-run (baseline, default knobs; traced on meta for "
          f"{', '.join(devices)})\n")
    print("| arch | shape | mesh | status | trace_s | args GiB | "
          "temp GiB | kernel calls |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] == "ok":
            m = r["memory"]
            ks = ", ".join(f"{k}:{v}" for k, v in
                           sorted(r.get("kernels", {}).items())) or "-"
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                  f"{r['trace_s']} | {fmt_bytes(m['argument_bytes'])} | "
                  f"{fmt_bytes(m['temp_bytes'])} | {ks} |")
        else:
            note = r.get("reason", r.get("error", ""))[:60]
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                  f"{r['status']} | - | - | - | {note} |")

    print("\n### Roofline (one device, analytic terms from kernel_model's "
          "peaks)\n")
    print("| arch | shape | compute ms | memory ms | collective ms | "
          "dominant | bound ms | MODEL_FLOPS/traced FLOPs | fits |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] != "ok":
            continue
        rf = r["roofline"]
        bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        peak = r["memory"]["peak_estimate_bytes"] / 2**30
        cap = r["capacity_bytes"] / 2**30
        print(f"| {r['arch']} | {r['shape']} | {rf['compute_s']*1e3:.1f} | "
              f"{rf['memory_s']*1e3:.1f} | {rf['collective_s']*1e3:.1f} | "
              f"{rf['dominant']} | {bound*1e3:.1f} | "
              f"{r['useful_flops_ratio']:.3f} | "
              f"{'yes' if r['fits'] else f'NO ({peak:.0f} of {cap:.0f} GiB)'}"
              " |")

    print("\n### Skipped cells\n")
    for r in rows:
        if r["status"] == "skipped":
            print(f"* {r['arch']} x {r['shape']}: {r['reason']}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else PATH)
