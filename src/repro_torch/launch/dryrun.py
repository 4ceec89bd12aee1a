"""Dry run of every (arch x shape) cell on one H100, traced on `meta`.

The port of `repro.launch.dryrun`.  The reference lowers and compiles
each cell's step for 512 placeholder devices and reads XLA's memory and
cost analyses.  The port runs each cell's whole step once on meta
tensors (shapes and dtypes, no storage) under
`roofline.component_costing.CostMode`, which counts every op's product
flops and bytes, the hand-written kernels' calls, and the live storage
bytes as the step allocates and frees them.  Per cell it writes one JSON
record:

  * `memory`: `argument_bytes` (params, optimizer state, batch, decode
    cache, exact), `temp_bytes` (the most the step's own allocations
    hold at once), `output_bytes` (what the step created that is alive
    at its end) and `peak_estimate_bytes` (arguments plus temp);
  * `roofline`: `analysis.Roofline.summary()` of the traced step;
  * `model_flops_total` / `_per_device` and `useful_flops_ratio`;
  * `fits`: the peak against the card's memory (`capacity_bytes`);
  * `trace_s`: the trace's seconds.

A cell a config cannot run is `skipped` with the reference's reason; one
that raises is an `error` record carrying the exception (for example
rwkv6-7b under `--quant ternary_packed`: the RWKV-6 block is dense only).

The step is the one the port runs: `train.loop.make_train_step` (AdamW
or 8-bit AdamW, `--microbatches`; gradient compression through
`trace_step`), the serving engine's prefill (`models.transformer.prefill`
and the last position's logits), and one `decode_step` at the cache's
last position.

`--device cuda` (the default) reads the card's name and memory from
`torch.cuda.get_device_properties`; `--device cpu` uses `kernel_model`'s
H100 SXM 80 GB constants and says so in each record.  Nothing runs on
either device: the trace is on meta.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --device cpu        (40 cells)
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as TF
from repro_torch.models.params import active_param_count, param_count
from repro_torch.optim.grad_compress import init_error_buffer
from repro_torch.roofline import kernel_model as KMOD
from repro_torch.roofline.analysis import Roofline, model_flops
from repro_torch.roofline.component_costing import (
    CostMode, cell_tokens, decode_position, tensors_in,
)
from repro_torch.train.loop import TrainLoopConfig, make_train_step

MESH = "1"          # one device: the records' `mesh`


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The reference's default with one device: 16 (d_model >= 7000) or
    8, lowered until it divides the batch."""
    per_shard = max(1, shape.global_batch)
    want = 16 if cfg.d_model >= 7000 else 8
    mb = min(want, per_shard)
    while per_shard % mb:
        mb -= 1
    return max(1, mb)


def device_info(device: str) -> dict:
    """`{"name", "capacity_bytes", "source"}` of the card the cells are
    costed for."""
    if device == "cuda":
        props = torch.cuda.get_device_properties(0)
        return {"name": props.name, "capacity_bytes": int(props.total_memory),
                "source": "torch.cuda.get_device_properties"}
    if device == "cpu":
        return {"name": KMOD.DEVICE_NAME,
                "capacity_bytes": int(KMOD.HBM_CAPACITY_BYTES),
                "source": "kernel_model constants (--device cpu)"}
    raise ValueError(f"--device must be cuda or cpu, got {device!r}")


def step_fn(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
            grad_compress: bool = False, cache_len: int | None = None):
    """`(fn, args)`: the cell's step as a function of nothing, and its
    meta arguments (params, optimizer state, batch, decode cache, error
    buffer), which the step reads and which live throughout.  A prefill
    fills a `cache_len`-slot cache (`shape.seq_len` slots when None)."""
    S = shape.seq_len
    if shape.kind == "train":
        params, opt = SP.abstract_state(cfg)
        batch = SP.train_batch_specs(cfg, shape)
        err = init_error_buffer(params) if grad_compress else None
        step = make_train_step(cfg, TrainLoopConfig(
            microbatches=microbatches, grad_compress=grad_compress))
        return (lambda: step(params, opt, batch, err),
                (params, opt, batch, err))
    params = SP.abstract_params(cfg)
    if shape.kind == "prefill":
        batch = SP.train_batch_specs(cfg, shape, with_labels=False)

        def prefill():
            with torch.inference_mode():
                hidden, cache = TF.prefill(cfg, params, batch,
                                           cache_len or S)
                return TF.logits_from_hidden(cfg, params,
                                             hidden[:, -1:, :]), cache
        return prefill, (params, batch)
    cache, tok, _, *positions = SP.decode_inputs(cfg, shape)
    pos = decode_position(S)

    def decode():
        with torch.inference_mode():
            return TF.decode_step(cfg, params, cache, tok, pos, *positions)
    return decode, (params, cache, tok, positions)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
               grad_compress: bool = False,
               cache_len: int | None = None) -> dict:
    """The whole step once on meta: `{"cost", "memory"}`."""
    fn, args = step_fn(cfg, shape, microbatches, grad_compress, cache_len)
    with CostMode(track_memory=True, external=args) as mode:
        out = fn()
    argument = mode.external_bytes
    # the step's results alive at its end (those not written in place)
    given = {t.untyped_storage()._cdata for t in tensors_in(args)}
    outputs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
               for t in tensors_in(out)
               if t.untyped_storage()._cdata not in given}
    mem = {"argument_bytes": argument,
           "output_bytes": sum(outputs.values()),
           "temp_bytes": mode.peak,
           "alias_bytes": 0,
           "peak_estimate_bytes": argument + mode.peak}
    return {"cost": mode.cost, "memory": mem}


def configure(arch: str, quant=None, remat=None, accum_dtype=None,
              kv_dtype=None) -> ModelConfig:
    cfg = get_config(arch)
    if quant:
        cfg = cfg.replace(quant=quant)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if accum_dtype:
        cfg = cfg.replace(accum_dtype=accum_dtype)
    if kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_dtype)
    return cfg


def lower_cell(arch: str, shape_name: str, *, device: dict,
               quant: str | None = None, microbatches: int | None = None,
               remat: bool | None = None, accum_dtype: str | None = None,
               kv_dtype: str | None = None) -> dict:
    """One cell's record."""
    cfg = configure(arch, quant, remat, accum_dtype, kv_dtype)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": MESH,
                 "device": device["name"], "device_source": device["source"],
                 "quant": cfg.quant, "remat": cfg.remat,
                 "accum_dtype": cfg.accum_dtype, "moe_fsdp": cfg.moe_fsdp,
                 "kv_cache_dtype": cfg.kv_cache_dtype,
                 "opt_8bit": cfg.opt_8bit,
                 "params": param_count(cfg.replace(quant="dense")),
                 "active_params": active_param_count(
                     cfg.replace(quant="dense"))}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    mb = 1
    if shape.kind == "train":
        mb = microbatches or default_microbatches(cfg, shape)
        rec["microbatches"] = mb
    t0 = time.monotonic()
    traced = trace_step(cfg, shape, mb)
    rec["trace_s"] = round(time.monotonic() - t0, 1)
    cost = traced["cost"]
    rec["memory"] = traced["memory"]
    rec["capacity_bytes"] = device["capacity_bytes"]
    rec["fits"] = traced["memory"]["peak_estimate_bytes"] \
        <= device["capacity_bytes"]
    roof = Roofline(flops_by_class=cost.flops, bytes_accessed=cost.bytes)
    rec["roofline"] = roof.summary()
    rec["kernels"] = cost.kernels
    mf = model_flops(rec["active_params"], cell_tokens(shape), shape.kind)
    rec["model_flops_total"] = mf
    rec["model_flops_per_device"] = mf
    rec["useful_flops_ratio"] = mf / max(roof.flops, 1.0)
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quant", default=None,
                    choices=[None, "dense", "ternary", "ternary_packed"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=[None, "on", "off"])
    ap.add_argument("--accum-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--kv-dtype", default=None,
                    choices=[None, "compute", "float8_e4m3fn"])
    ap.add_argument("--out", default="reports/dryrun_torch.jsonl")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    remat = None if args.remat is None else (args.remat == "on")
    device = device_info(args.device)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    t_all = time.monotonic()
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                label = f"{arch} x {shape}"
                try:
                    rec = lower_cell(arch, shape, device=device,
                                     quant=args.quant,
                                     microbatches=args.microbatches,
                                     remat=remat,
                                     accum_dtype=args.accum_dtype,
                                     kv_dtype=args.kv_dtype)
                except Exception as e:   # noqa: BLE001 — report & continue
                    rec = {"arch": arch, "shape": shape, "mesh": MESH,
                           "device": device["name"],
                           "quant": args.quant or get_config(arch).quant,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    n_fail += 1
                f.write(json.dumps(rec) + "\n")
                f.flush()
                if rec["status"] == "ok":
                    m, r = rec["memory"], rec["roofline"]
                    print(f"[ok] {label}: trace {rec['trace_s']}s | "
                          f"args {m['argument_bytes'] / 2**30:.2f} GiB, "
                          f"peak {m['peak_estimate_bytes'] / 2**30:.2f} GiB"
                          f"{'' if rec['fits'] else ' (does not fit)'} | "
                          f"compute {r['compute_s'] * 1e3:.1f} ms, "
                          f"memory {r['memory_s'] * 1e3:.1f} ms "
                          f"-> {r['dominant']}-bound", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {label}: {rec['reason']}", flush=True)
                else:
                    print(f"[FAIL] {label}: {rec['error']}", flush=True)
    print(f"[done] {len(archs) * len(shapes)} cells in "
          f"{time.monotonic() - t_all:.1f}s on {device['name']}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
