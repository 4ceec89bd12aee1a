#!/usr/bin/env python3
"""Where a serving dispatch, or an LM step, spends its time on the GPU.

    python3 tools/chip_profile.py          # compiled classifiers
    python3 tools/chip_profile.py --lm     # llama3.2-1b, ternary_packed
    python3 tools/chip_profile.py --lm --arch rwkv6-7b   # dense bf16
    python3 tools/chip_profile.py --families   # launch.families.FAMILIES

Loads the arrhythmia and cardio tenants of `tests/golden_emit/` on the
current CUDA device and, at 1,024 and 65,536 readings a dispatch, prints
one JSON line each with:

  * `stages_ms` — the median host-clock time of each stage of
    `CircuitProgram.predict` with a device synchronise after every stage:
    `binarize` (host-to-device copy of the float readings and the float64
    threshold compare), `pack` (bit packing on the device) and
    `eval_words` (the gate-walk kernel on the plan and level schedule the
    program holds on the card, labels back to the host), beside the whole
    `predict`;
  * `profile` — `torch.profiler` over 10 engine dispatches: the device's
    busy time (the sum of its kernels, copies and memsets) against the
    wall time, and the five largest device-side entries.

With `--lm` it serves llama3.2-1b at full width (bf16, 2-bit packed
ternary projections), or with `--arch rwkv6-7b` RWKV-6 at full width
(dense bf16), weights drawn on the card from seed 0 by
`models.params.serving_params`, and prints one JSON line each for a prefill of
8 x 96 prompt tokens and for decode steps at batch 8 (positions 96
onwards): the unprofiled median host-clock time of the step (ending with
the tokens on the host, as the engine's), and under `torch.profiler` the
device busy share and the largest device-side entries, with each
hand-written kernel's share of the busy time.

With `--families` it does the same for every row of
`repro_torch.launch.families.FAMILIES` in turn (each arch at its
published width and the depth, quant, prompt length and `cache_len`
`chip_smoke.py`'s `lm_families` phase serves, weights drawn on the card
from seed 0 and packed there): a prefill of 8 prompts and decode steps
from it, one JSON line each, tagged with the arch.

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
# the ternary matmul's three designs (split-K decode, tensor-core prefill,
# CUDA-core f32), the WKV-6 scan and its backward
KERNELS = ("ternary_splitk_kernel", "ternary_mma_kernel",
           "ternary_matmul_kernel", "rwkv6_scan_kernel",
           "rwkv6_scan_bwd_kernel")


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


def device_profile(fn, reps: int) -> dict:
    """`torch.profiler` over `reps` calls of `fn`: wall time, device busy
    time and share, the eight largest device-side entries, and the share
    of the busy time spent in each hand-written kernel of `KERNELS`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side activities only (kernels, memcpy, memset): the CPU ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key not in PROFILER_OWN
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "calls": reps,
        "device_ops_per_call": sum(e.count for e in events) / reps,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_share_of_busy": {
            k: sum(e.self_device_time_total for e in events if k in e.key)
            / busy_us if busy_us else 0.0 for k in KERNELS},
        "top": [{"name": e.key[:90],
                 "device_ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def profile_lm(arch: str) -> None:
    """Prefill and decode of llama3.2-1b (ternary_packed, bf16) or
    rwkv6-7b (dense, bf16), prompts of 96 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import serving_params

    cfg = get_config(arch)
    if arch == "llama3.2-1b":
        cfg = cfg.replace(quant="ternary_packed")
    profile_steps(cfg, serving_params(cfg, 0), 96, 256)


def profile_families() -> None:
    """Every row of `launch.families.FAMILIES`, built and served as
    `chip_smoke.py`'s `lm_families` phase does."""
    import gc

    import torch

    from repro_torch.launch.families import FAMILIES
    from repro_torch.models.params import serving_params

    for fam in FAMILIES:
        cfg = fam.config()
        profile_steps(cfg, serving_params(cfg, 0), fam.prompt_tokens,
                      fam.cache_len)
        gc.collect()
        torch.cuda.empty_cache()


def profile_steps(cfg, params: dict, plen: int, cache_len: int) -> None:
    """One JSON line for a prefill of 8 seeded prompts of `plen` tokens
    and one for decode steps at batch 8 from it."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.serve.lm_engine import ServingEngine, make_batch

    engine = ServingEngine(cfg, params, max_batch=8, cache_len=cache_len)
    params = engine.params
    rng = np.random.default_rng(0)
    batch = make_batch(cfg, rng.integers(1, cfg.vocab, (8, plen)),
                       engine.device)

    def prefill():
        with torch.inference_mode():
            hidden, cache = TF.prefill(cfg, params, batch, cache_len)
            logits = TF.logits_from_hidden(cfg, params, hidden[:, -1:])
            return torch.argmax(logits, dim=-1).cpu(), cache

    tok, cache = prefill()
    tok = tok.to(engine.device)
    pos = [plen]

    def decode():
        with torch.inference_mode():
            logits, _ = TF.decode_step(cfg, params, cache, tok, pos[0])
            torch.argmax(logits, dim=-1).cpu()
        pos[0] += 1

    print(json.dumps({"lm": cfg.name, "phase": "prefill", "batch": 8,
                      "n_layers": cfg.n_layers, "quant": cfg.quant,
                      "kv_cache_dtype": cfg.kv_cache_dtype,
                      "prompt_tokens": plen,
                      "step_ms": median_ms(lambda: prefill(), 5),
                      "profile": device_profile(lambda: prefill(), 3)}),
          flush=True)
    print(json.dumps({"lm": cfg.name, "phase": "decode", "batch": 8,
                      "n_layers": cfg.n_layers,
                      "step_ms": median_ms(decode, 20),
                      "profile": device_profile(decode, 10)}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    args = sys.argv[1:]
    if "--families" in args:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "torch": torch.__version__}), flush=True)
        profile_families()
        return 0
    if "--lm" in args:
        arch = args[args.index("--arch") + 1] if "--arch" in args \
            else "llama3.2-1b"
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "torch": torch.__version__}), flush=True)
        profile_lm(arch)
        return 0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compile.artifact import load_manifest, load_program
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
        for batch in (1024, 65536):
            x = thr[None, :] + rng.standard_normal(
                (batch, thr.shape[0]), dtype=np.float32) * np.maximum(
                    np.abs(thr), 1.0)[None, :]
            xbin = prog.binarize(x)
            words = prog.pack_input_bits(xbin)
            stages = {
                "binarize": median_ms(lambda: prog.binarize(x)),
                "pack": median_ms(lambda: prog.pack_input_bits(xbin)),
                "eval_words": median_ms(lambda: prog.eval_words(words)),
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
