"""Roofline table from the port's dry-run records
(`reports/dryrun_torch.jsonl`, written by `python -m
repro_torch.launch.dryrun`).

The port of `benchmarks/roofline_bench.py`: one row per cell (the last
record of a cell wins, so reruns override), with the three terms in
milliseconds, the dominant one, the step's peak memory and the model's
useful share of the traced flops.  The terms are analytic: a meta trace
of the step priced at `repro_torch.roofline.kernel_model`'s H100 SXM
peaks; nothing here is measured on a card.
"""
from __future__ import annotations

import json
import os

PATH = "reports/dryrun_torch.jsonl"


def load(path: str = PATH) -> dict:
    """`{(arch, shape, mesh, quant): record}`, the last record of each."""
    best: dict[tuple, dict] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["arch"], rec["shape"], rec["mesh"],
                   rec.get("quant", "dense"))
            best[key] = rec
    return best


def run(device=None, path: str = PATH) -> list[dict]:
    """The rows (`device` is not used: the records are analytic)."""
    if not os.path.exists(path):
        return [{"bench": "roofline", "note": f"{path} missing — run "
                 "`python -m repro_torch.launch.dryrun --arch all --shape "
                 "all`"}]
    rows = []
    for (arch, shape, mesh, quant), rec in sorted(load(path).items()):
        if rec["status"] != "ok":
            rows.append({"bench": "roofline", "arch": arch, "shape": shape,
                         "mesh": mesh, "quant": quant,
                         "status": rec["status"],
                         "note": rec.get("reason", rec.get("error", ""))[:90]})
            continue
        r = rec["roofline"]
        m = rec["memory"]
        rows.append({
            "bench": "roofline", "arch": arch, "shape": shape, "mesh": mesh,
            "quant": quant, "status": "ok",
            "compute_ms": round(r["compute_s"] * 1e3, 2),
            "memory_ms": round(r["memory_s"] * 1e3, 2),
            "collective_ms": round(r["collective_s"] * 1e3, 2),
            "dominant": r["dominant"],
            "hbm_gib_per_dev": round(m["peak_estimate_bytes"] / 2**30, 2),
            "fits": rec["fits"],
            "useful_flops_ratio": round(rec["useful_flops_ratio"], 4),
            "trace_s": rec["trace_s"],
        })
    return rows
