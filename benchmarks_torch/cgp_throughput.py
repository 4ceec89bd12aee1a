"""CGP fitness throughput: serial per-child loop vs population-parallel.

The acceptance metric for the batched evaluator: at lambda >= 16 the
`NetlistPopulation` path must sustain >= 5x the fitness evaluations/s of
the per-child loop (identical work per eval: simulate all packed vectors
+ decode + error stats + active-area cost).

The port of `benchmarks/cgp_throughput.py`, on `device`:

  * ``serial_evals_per_s`` — the per-child loop `cgp._errors` /
    `cgp._area_of`: each child one gate-walk call on `device` (the
    reference's serial column runs `Netlist.simulate` in numpy; the port
    keeps no second numpy simulator, so its serial column pays one
    dispatch a child instead);
  * ``batched_evals_per_s`` — `NetlistPopulation.pc_errors` + `areas`:
    every child in one launch;
  * ``device_evals_per_s`` (the reference's ``jax_evals_per_s``) — the
    same launch with the word plane and the true counts uploaded once,
    through `kernels.dispatch.population_pc_errors`.

Run directly to write the artifact (never the reference's
`BENCH_cgp.json`):

    PYTHONPATH=src python -m benchmarks_torch.cgp_throughput \
        [build/BENCH_cgp_torch.json] [--device cpu]
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.cgp import (CGPConfig, _area_of, _errors, _mutate,
                                  _population_of, _seed_genome,
                                  evolve_popcount)
from repro_torch.core.circuits import (eval_vectors, popcount_netlist,
                                       popcount_width)
from benchmarks_torch.common import QUICK

OUT_PATH = "build/BENCH_cgp_torch.json"


def _mutant_population(n: int, lam: int, seed: int = 0):
    """lam realistic CGP mutants of the exact n-input popcount."""
    rng = np.random.default_rng(seed)
    exact = popcount_netlist(n)
    cfg = CGPConfig(n_inputs=n, n_outputs=popcount_width(n),
                    n_nodes=exact.n_gates + 16, lam=lam)
    parent = _seed_genome(exact, cfg.n_nodes, rng, cfg.funcs)
    return [_mutate(parent, cfg, rng)[0] for _ in range(lam)]


def _time(fn, reps: int) -> float:
    fn()                                   # warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure(n: int, lam: int, reps: int, seed: int = 0, device=None) -> dict:
    import torch

    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels.dispatch import population_pc_errors

    dev = resolve_device(device)
    genomes = _mutant_population(n, lam, seed)
    packed, true = eval_vectors(n)

    def serial():
        for g in genomes:
            _errors(g, packed, true, dev)
            _area_of(g)

    def batched():
        pop = _population_of(genomes)
        pop.pc_errors(packed, true, device=dev)
        pop.areas()

    t_serial = _time(serial, reps)
    t_batched = _time(batched, reps)
    row = {
        "bench": "cgp_throughput", "n": n, "lam": lam,
        "serial_evals_per_s": round(lam / t_serial, 1),
        "batched_evals_per_s": round(lam / t_batched, 1),
        "speedup": round(t_serial / t_batched, 2),
    }
    pop = _population_of(genomes)
    words = CS.words_tensor(CS.pack_words32(packed), dev)
    true_dev = torch.from_numpy(np.ascontiguousarray(true)).to(dev)

    def device_path():
        mae, _ = population_pc_errors(pop, words, true_dev, devices=[dev])
        np.asarray(mae)

    row["device_evals_per_s"] = round(lam / _time(device_path, reps), 1)
    return row


def measure_evolution(n: int, lam: int, iters: int, seed: int = 0,
                      device=None) -> dict:
    """End-to-end evolve_popcount wall-clock, batched vs serial loop."""
    packed_true = eval_vectors(n)

    def run(batch: bool):
        cfg = CGPConfig(n_inputs=n, n_outputs=popcount_width(n),
                        n_nodes=popcount_netlist(n).n_gates + 16,
                        tau=0.5, max_iters=iters, seed=seed, lam=lam,
                        batch_eval=batch)
        t0 = time.perf_counter()
        res = evolve_popcount(cfg, eval_set=packed_true, device=device)
        return res, time.perf_counter() - t0

    res_b, t_b = run(True)
    res_s, t_s = run(False)
    assert res_b.best_area == res_s.best_area      # identical trajectories
    return {
        "bench": "cgp_throughput_e2e", "n": n, "lam": lam, "iters": iters,
        "serial_evals_per_s": round(res_s.evaluations / t_s, 1),
        "batched_evals_per_s": round(res_b.evaluations / t_b, 1),
        "speedup": round(t_s / t_b, 2),
        "best_area": res_b.best_area,
    }


def run(sizes=None, device=None) -> list[dict]:
    reps = 3 if QUICK else 10
    combos = sizes or ([(8, 16), (8, 32), (12, 32)] if QUICK
                       else [(8, 16), (8, 32), (8, 64), (12, 32), (16, 32)])
    rows = [measure(n, lam, reps, device=device) for (n, lam) in combos]
    rows.append(measure_evolution(8, 16, 60 if QUICK else 200,
                                  device=device))
    return rows


def main(out_path: str = OUT_PATH, device=None) -> None:
    dev = resolve_device(device)
    rows = run(device=dev)
    payload = {"bench": "cgp_throughput", "device": str(dev),
               "note": "fitness evals/s, serial per-child loop (one "
                       "gate-walk call a child) vs population-parallel "
                       "NetlistPopulation (one launch, same work)",
               "rows": rows}
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    for r in rows:
        print(r)
    print(f"wrote {out_path}")


def _cli(argv=None) -> tuple[str, str | None]:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=OUT_PATH)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    return a.out, a.device


if __name__ == "__main__":
    main(*_cli(sys.argv[1:]))
