"""Roofline of every (arch x shape) cell on one H100: components x trips
plus the analytic memory model.

The port of `repro.launch.roofline_run`.  Per cell it writes one JSON
record to `reports/roofline_torch.jsonl`:

  * `roofline`: the traced compute and memory terms of the step, from its
    components times their trip counts (`roofline.component_costing`,
    traced on `meta`), and `breakdown`, each component's flops, bytes,
    kernel calls and trips;
  * `memory_analytic`: `roofline.memory_model.analytic_memory_bytes` at
    one device, and `memory_analytic_s` at the card's HBM rate;
  * `dominant` and `bound_s`: the largest of the compute, analytic-memory
    and (zero) collective terms, as the reference takes them;
  * `model_flops_per_device`, `useful_flops_ratio` and
    `roofline_fraction`: the model's useful flops (6 N D or 2 N D) at
    `BF16_FLOP_PER_S` over the bound.

Every peak is `roofline.kernel_model`'s (NVIDIA H100 SXM data sheet); no
figure is measured here.  The reference's sharding flags (`--moe-fsdp`,
`--serve-tp-only`, `--replicate-kv`, `--sharded-logits`) have no
meaning on one device and are not taken.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline_run
       [--arch all] [--shape all] [--quant ...] [--microbatches N]
       [--capacity-factor F] [--tag label]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch.dryrun import configure
from repro_torch.models.params import active_param_count
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.component_costing import cost_cell
from repro_torch.roofline.kernel_model import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from repro_torch.roofline.memory_model import analytic_memory_bytes


def run_cell(arch: str, shape_name: str, *, quant=None, microbatches=None,
             remat=None, kv_dtype=None, capacity_factor=None) -> dict:
    """One cell's record."""
    cfg = configure(arch, quant, remat, None, kv_dtype)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "quant": cfg.quant,
           "remat": cfg.remat, "kv_cache_dtype": cfg.kv_cache_dtype,
           "opt_8bit": cfg.opt_8bit,
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if shape.kind == "train":
        mb = microbatches or min(16 if cfg.d_model >= 7000 else 8,
                                 max(1, shape.global_batch))
    else:
        mb = 1
    rec["microbatches"] = mb
    t0 = time.monotonic()
    out = cost_cell(cfg, shape, mb)
    rec["cost_s"] = round(time.monotonic() - t0, 1)
    roof = out["roofline"]
    mem = analytic_memory_bytes(cfg, shape, mb)
    rec["roofline"] = roof
    rec["breakdown"] = out["breakdown"]
    rec["kernels"] = out["kernels"]
    rec["memory_analytic"] = mem
    rec["memory_analytic_s"] = mem["total"] / HBM_BYTES_PER_S
    terms = {"compute": roof["compute_s"],
             "memory": mem["total"] / HBM_BYTES_PER_S,
             "collective": roof["collective_s"]}
    rec["dominant"] = max(terms, key=terms.get)
    rec["bound_s"] = max(terms.values())
    mf = model_flops(active_param_count(cfg.replace(quant="dense")),
                     out["tokens"], shape.kind)
    rec["model_flops_per_device"] = mf
    rec["useful_flops_ratio"] = mf / max(roof["flops_per_device"], 1.0)
    # roofline fraction: useful model flops time / achievable bound
    rec["roofline_fraction"] = (mf / BF16_FLOP_PER_S) / max(rec["bound_s"],
                                                            1e-12)
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--quant", default=None,
                    choices=[None, "dense", "ternary", "ternary_packed"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=[None, "on", "off"])
    ap.add_argument("--kv-dtype", default=None,
                    choices=[None, "compute", "float8_e4m3fn"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default="reports/roofline_torch.jsonl")
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    remat = None if args.remat is None else (args.remat == "on")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, quant=args.quant,
                                   microbatches=args.microbatches,
                                   remat=remat, kv_dtype=args.kv_dtype,
                                   capacity_factor=args.capacity_factor)
                except Exception as e:   # noqa: BLE001
                    rec = {"arch": arch, "shape": shape, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-1500:]}
                    n_fail += 1
                rec["tag"] = args.tag
                f.write(json.dumps(rec) + "\n")
                f.flush()
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[ok] {arch} x {shape}: "
                          f"compute {r['compute_s'] * 1e3:.1f} ms | "
                          f"mem(traced) {r['memory_s'] * 1e3:.0f} ms | "
                          f"mem(analytic) "
                          f"{rec['memory_analytic_s'] * 1e3:.1f} ms "
                          f"-> {rec['dominant']}-bound, "
                          f"roofline {rec['roofline_fraction']:.1%} "
                          f"({rec['cost_s']}s)", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {arch} x {shape}", flush=True)
                else:
                    print(f"[FAIL] {arch} x {shape}: {rec['error']}",
                          flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
