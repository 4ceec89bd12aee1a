#!/usr/bin/env python3
"""Where a serving dispatch spends its time on the GPU.

    python3 tools/chip_profile.py

Loads the arrhythmia and cardio tenants of `tests/golden_emit/` on the
current CUDA device and, at 1,024 and 65,536 readings a dispatch, prints
one JSON line each with:

  * `stages_ms` — the median host-clock time of each stage of
    `CircuitProgram.predict` with a device synchronise after every stage:
    `binarize` (host-to-device copy of the float readings and the float64
    threshold compare), `pack` (bit packing on the device) and
    `eval_words` (plan check and upload, the gate-walk kernel, labels back
    to the host), beside the whole `predict`;
  * `profile` — `torch.profiler` over 10 engine dispatches: the device's
    busy time (the sum of its kernels, copies and memsets) against the
    wall time, and the five largest device-side entries.

The profiler adds its own host overhead to the wall time, so the busy
share it reports is a lower bound.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS = 15
PROFILED_DISPATCHES = 10
PROFILER_OWN = {"Activity Buffer Request"}   # the profiler's own bookkeeping


def median_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compile.artifact import load_manifest, load_program
    from repro_torch.kernels import dispatch as D
    from repro_torch.serve.engine import CircuitServingEngine

    emit = ROOT / "tests" / "golden_emit"
    rows = {r["name"]: r for r in load_manifest(emit)}
    rng = np.random.default_rng(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    for name in ("arrhythmia", "cardio"):
        prog = load_program(emit / rows[name]["program"],
                            expect_sha256=rows[name]["sha256"])
        thr = prog.thresholds.astype(np.float32)
        plan = [np.reshape(a, (1, -1)) for a in prog.plan()[:4]]
        for batch in (1024, 65536):
            x = thr[None, :] + rng.standard_normal(
                (batch, thr.shape[0]), dtype=np.float32) * np.maximum(
                    np.abs(thr), 1.0)[None, :]
            xbin = prog.binarize(x)
            words = prog.pack_input_bits(xbin)
            stages = {
                "binarize": median_ms(lambda: prog.binarize(x)),
                "pack": median_ms(lambda: prog.pack_input_bits(xbin)),
                "eval_words": median_ms(lambda: D.program_eval_words(
                    *plan, words, prog.ir.n_inputs,
                    devices=(prog.device,))),
                "predict": median_ms(lambda: prog.predict(x)),
            }
            eng = CircuitServingEngine(prog, max_batch=batch)
            eng.warmup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_DISPATCHES):
                    eng.classify_batch(x)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            # device-side activities only (kernels, memcpy, memset): the
            # CPU ops that launched them carry the same time again
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.key not in PROFILER_OWN
                      and e.self_device_time_total > 0]
            busy_us = sum(e.self_device_time_total for e in events)
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
            print(json.dumps({
                "tenant": name, "readings": batch, "stages_ms": stages,
                "profile": {
                    "dispatches": PROFILED_DISPATCHES,
                    "wall_ms": wall_us / 1e3,
                    "device_busy_ms": busy_us / 1e3,
                    "device_busy_share": busy_us / wall_us,
                    "top": [{"name": e.key[:90],
                             "device_ms": e.self_device_time_total / 1e3,
                             "count": e.count} for e in top],
                }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
