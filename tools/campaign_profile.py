#!/usr/bin/env python3
"""Where a Phase-1 (CGP) generation's time goes on a CUDA card's host.

    PYTHONPATH=src python tools/campaign_profile.py [--n 130] [--iters 60]

Prints one JSON object per line:

  * `host` — the numpy work of one generation at n inputs on the
    reference's grid, medians of 10: the parent's liveness sweep
    (`_Genome.active_nodes`), the lambda = 4 children's liveness and areas
    (`NetlistPopulation.areas`), and one fitness call on the card
    (`NetlistPopulation.pc_errors`: the raw plan's schedule built on the
    card, one launch, errors reduced on the card, two arrays back);
  * `generation` — one `evolve_popcount` run of `--iters` generations,
    ms a generation, and the functions that take the most time under
    `cProfile` (which inflates Python-heavy ones);
  * `tau_points` — the four tau points of `tau_schedule(n, 2)` as
    `evolve_popcount` runs on the card, one after another and in a pool of
    four threads, the seconds of each; the card's `nvidia-smi` name and
    power limit.

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def median_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=130)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("campaign_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.core import cgp
    from repro_torch.core import circuits as C
    from repro_torch.kernels import circuit_sim as CS

    dev = resolve_device(None)
    n = args.n
    exact = C.popcount_netlist(n)
    grid = max(exact.n_gates + 16, int(exact.n_gates * 1.5))
    packed, true = C.eval_vectors(n)
    rng = np.random.default_rng(0)
    cfg = cgp.CGPConfig(n_inputs=n, n_outputs=C.popcount_width(n),
                        n_nodes=grid)
    root = cgp._seed_genome(exact, grid, rng, cfg.funcs)
    live = root.active_nodes()
    kids = [cgp._mutate(root, cfg, rng, active=live)[0] for _ in range(4)]
    pop = cgp._population_of(kids)
    words = CS.words_tensor(CS.pack_words32(packed), dev)
    true_dev = torch.from_numpy(true).to(dev)
    pop.pc_errors(words, true_dev, device=dev)        # build and warm up
    print(json.dumps({"phase": "host", "n": n, "grid": grid, "P": 4,
                      "W": int(words.shape[1]),
                      "active_nodes_ms": median_ms(root.active_nodes),
                      "areas_ms": median_ms(pop.areas),
                      "fitness_call_ms": median_ms(lambda: pop.pc_errors(
                          words, true_dev, device=dev))}), flush=True)

    def run(point: tuple[int, str, float]) -> float:
        i, metric, tau = point
        t = time.perf_counter()
        cgp.evolve_popcount(cgp.CGPConfig(
            n_inputs=n, n_outputs=C.popcount_width(n), n_nodes=grid,
            seed=i, max_iters=args.iters, tau=tau, error_metric=metric),
            eval_set=(packed, true), device=dev)
        return time.perf_counter() - t

    points = [(i, m, t) for i, (m, t) in enumerate(cgp.tau_schedule(n, 2))]
    prof = cProfile.Profile()
    prof.enable()
    run(points[0])
    prof.disable()
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:6]
    print(json.dumps({
        "phase": "generation", "iters": args.iters,
        "ms_a_generation": run(points[0]) / args.iters * 1e3,
        "profiled_tottime_s": {f"{Path(f).name}:{ln}({fn})": v[2]
                               for (f, ln, fn), v in top}}), flush=True)
    t = time.perf_counter()
    serial = [run(p) for p in points]
    serial_s = time.perf_counter() - t
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(points)) as ex:
        threaded = list(ex.map(run, points))
    threaded_s = time.perf_counter() - t
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"phase": "tau_points", "points": len(points),
                      "iters": args.iters, "serial_s": serial_s,
                      "serial_each_s": serial, "threads_s": threaded_s,
                      "threads_each_s": threaded, "nvidia_smi": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
