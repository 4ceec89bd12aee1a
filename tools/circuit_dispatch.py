#!/usr/bin/env python3
"""Host and device time of the gate-walk entry points a caller dispatches.

    python3 tools/circuit_dispatch.py [--src DIR]

Imports `repro_torch` from `DIR` (default: this checkout's `src/`), so
one call can time two versions of the port in turns on one card, e.g. an
unpacked copy of an older commit and this one.  It uses only entry points
whose signatures every version of the port shares, and prints one JSON
line per measurement:

  * `fleet` — the five tenants of `tests/golden_emit/` at 1,024 and
    65,536 readings each: `dispatch_p50_ms`, `dispatch.fleet_eval_words`
    on the host's clock (numpy word planes in, labels on the host), and
    `wrapper_ms`, `cuda_circuit_sim.fleet_eval_words` on device tensors
    (CUDA events);
  * `raw_population` — a random feed-forward population (P = 64, G =
    4,096, 32 inputs, 8 outputs) over 2,048 readings: `dispatch_p50_ms`,
    `dispatch.population_eval_uint` on the host's clock, and
    `wrapper_ms`, `cuda_circuit_sim.fused_eval_uint` on device tensors;
  * `program` — the arrhythmia plan at 1,024 readings:
    `dispatch.program_eval_words` on the host's clock, and
    `engine_dispatch_p50_ms`, a `CircuitServingEngine(max_batch=1024)`
    dispatch.

Device times are medians of CUDA-event pairs around the call, after a
spin kernel so the host has queued the call before the first event
fires; host times are medians of the wall clock.  Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS = 25
SEED = 0


def wall_ms(fn, reps: int = REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.compile.artifact import load_manifest, load_program
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.kernels import dispatch as D
    from repro_torch.serve.engine import CircuitServingEngine

    dev = torch.device("cuda", 0)
    emit, golden = ROOT / "tests" / "golden_emit", ROOT / "tests" / "golden"
    progs = {r["name"]: load_program(emit / r["program"], device=dev,
                                     expect_sha256=r["sha256"])
             for r in load_manifest(emit)}
    xs = {n: np.load(golden / f"{n}.npz")["x"] for n in progs}
    src = str(Path(args.src).resolve().relative_to(ROOT))

    plans = [p.plan() for p in progs.values()]
    for batch in (1024, 65536):
        words = [p.pack_input_bits(p.binarize(
            np.tile(xs[n], (-(-batch // 96), 1))[:batch]))
            for n, p in progs.items()]
        words_np = [w.cpu().numpy().view(np.uint32) for w in words]
        print(json.dumps({
            "measure": "fleet", "src": src, "readings_each": batch,
            "dispatch_p50_ms": wall_ms(
                lambda: D.fleet_eval_words(plans, words_np, device=dev)),
            "wrapper_ms": device_ms(
                lambda: CK.fleet_eval_words(plans, words))}), flush=True)

    rng = np.random.default_rng(SEED)
    n_in, G, n_out, P, W64 = 32, 4096, 8, 64, 32
    hi = n_in + np.arange(G)
    op = rng.integers(1, 13, size=(P, G)).astype(np.int32)
    in0, in1 = (rng.integers(0, hi[None, :], size=(P, G)).astype(np.int32)
                for _ in range(2))
    outputs = rng.integers(0, n_in + G, size=(P, n_out)).astype(np.int32)
    packed = rng.integers(0, 2 ** 63, size=(n_in, W64), dtype=np.uint64)
    plan_t = [torch.from_numpy(a).to(dev) for a in (op, in0, in1, outputs)]
    words_t = torch.from_numpy(
        packed.view(np.uint32).view(np.int32).copy()).to(dev)
    print(json.dumps({
        "measure": "raw_population", "src": src, "P": P, "G": G,
        "readings": W64 * 64,
        "dispatch_p50_ms": wall_ms(lambda: D.population_eval_uint(
            op, in0, in1, outputs, packed, n_in, devices=(dev,))),
        "wrapper_ms": device_ms(
            lambda: CK.fused_eval_uint(*plan_t, words_t, n_in))}),
        flush=True)

    arr = progs["arrhythmia"]
    x = np.tile(xs["arrhythmia"], (11, 1))[:1024]
    words_np = arr.pack_input_bits(arr.binarize(x)).cpu().numpy() \
        .view(np.uint32)
    rows = [np.reshape(a, (1, -1)) for a in arr.plan()[:4]]
    eng = CircuitServingEngine(arr, max_batch=1024)
    eng.warmup()
    for _ in range(REPS):
        eng.classify_batch(x)
    print(json.dumps({
        "measure": "program", "src": src, "tenant": "arrhythmia",
        "readings": 1024,
        "program_eval_words_p50_ms": wall_ms(lambda: D.program_eval_words(
            *rows, words_np, arr.ir.n_inputs, devices=(dev,))),
        "engine_dispatch_p50_ms": eng.stats.percentile_ms(50)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
