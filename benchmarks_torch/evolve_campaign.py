"""Campaign fitness-eval throughput on the port, by device and by design.

The port of `benchmarks/evolve_campaign.py`.  The port has no backend
names: the device decides, and on the card the gate walk's routing picks
a design (`shared_plane`, the level walk over a shared-memory plane, or
`global_scratch`, the walk over a scratch plane in global memory).  Rows,
all measured as fitness evaluations per second:

  * ``evolve_eval`` — raw population x packed-word gate simulation (the
    CGP mutant workload of `cgp_throughput`) through
    `repro_torch.evolve.evaluator.population_pc_errors`:
    ``cpu_evals_per_s`` (the plain PyTorch walk on the CPU) and, on the
    card, ``cuda_evals_per_s`` (the routed launch, host work included),
    then ``shared_plane_evals_per_s`` and ``global_scratch_evals_per_s``
    (each design's launch alone, the words on the card) and
    ``global_scratch_vs_shared_plane``.  They take the places of the
    reference's ``np_``, ``swar_`` and ``pallas_evals_per_s`` and
    ``pallas_vs_swar``;
  * ``evolve_fused_kernel`` — the fused `cuda_circuit_sim.fused_eval_uint`
    against the two-stage `simulate_population` followed by the plain
    decode (`circuit_sim.decode_words`), same keys as the reference;
  * ``kernel_roofline`` — `repro_torch.roofline.kernel_model`'s rows per
    design (``plain``, ``shared_plane``, ``global_scratch`` in place of
    ``swar``, ``pallas_unfused``, ``pallas_fused``), with ``chain_s``
    beside the reference's keys, plus one padded fleet launch;
  * ``evolve_tnn_objective`` — the campaign objective on `device`:
    ``evals_per_s`` and ``device`` in place of the per-backend columns;
  * ``evolve_campaign``, ``evolve_parallel``, ``zoo_compile`` — as the
    reference's (host work, spawned workers, the zoo's cold/warm build).

Run directly to write the artifact (never the reference's
`BENCH_evolve.json`):

    PYTHONPATH=src python -m benchmarks_torch.evolve_campaign \
        [build/BENCH_evolve_torch.json] [--device cpu]
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from benchmarks_torch.common import QUICK
from benchmarks_torch.cgp_throughput import _mutant_population, _time
from repro_torch.core.cgp import _population_of
from repro_torch.core.circuits import eval_vectors
from repro_torch.evolve import Campaign, CampaignConfig, build_synth_problem
from repro_torch.evolve.evaluator import population_pc_errors

OUT_PATH = "build/BENCH_evolve_torch.json"


def _launch_args(pop, packed, dev) -> tuple:
    """A population's checked plan and its shared word plane on `dev`."""
    import torch

    from repro_torch.kernels import circuit_sim as CS

    plan = [torch.from_numpy(a).to(dev) for a in CS.check_plan(
        pop.op, pop.in0, pop.in1, pop.outputs, pop.n_inputs)]
    return (*plan, CS.words_tensor(CS.pack_words32(packed), dev),
            pop.n_inputs)


def _design_launch(design: str, args: tuple, sched) -> None:
    """One fused launch through `design`, whatever the routing would pick
    (a bench measurement: the launch counters are not touched)."""
    import torch

    from repro_torch.kernels import cuda_circuit_sim as CK

    op, in0, in1, outputs, words, n_in = args
    P, G = op.shape
    p = CK.route(P, G, words.shape[-1], n_in, outputs.shape[1], sched)
    if p.variant != design:
        if design == "shared_plane":
            raise ValueError("the plan does not fit the level walk")
        p = p._replace(variant=design)
    CK._launch(*args, True, sched, p, outputs.shape[1])
    torch.cuda.synchronize(words.device)


def measure_circuit(n: int, lam: int, reps: int, seed: int = 0,
                    device=None) -> dict:
    dev = resolve_device(device)
    pop = _population_of(_mutant_population(n, lam, seed))
    packed, true = eval_vectors(n)
    row = {"bench": "evolve_eval", "n": n, "lam": lam}
    devices = ["cpu"] + ([dev] if dev.type == "cuda" else [])
    for d in devices:
        def run(d=d):
            mae, _ = population_pc_errors(pop, packed, true, devices=[d])
            np.asarray(mae)
        row[f"{resolve_device(d).type}_evals_per_s"] = round(
            lam / _time(run, reps), 1)
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_circuit_sim as CK

        args = _launch_args(pop, packed, dev)
        sched = CK.schedule(*args[:3], args[-1], device=dev)
        for design in CK.VARIANTS:
            row[f"{design}_evals_per_s"] = round(lam / _time(
                lambda: _design_launch(design, args, sched), reps), 1)
        row["global_scratch_vs_shared_plane"] = round(
            row["global_scratch_evals_per_s"]
            / row["shared_plane_evals_per_s"], 3)
    return row


def measure_fused_kernel(n: int, lam: int, reps: int, seed: int = 0,
                         device=None) -> dict:
    """The fused launch vs the two-stage path on one device, one run:
    ``unfused`` runs `simulate_population` (output words) and then the
    plain decode's per-output-bit `(P, W, 32)` int32 planes; ``fused`` is
    the single launch whose decode never leaves the kernel."""
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK

    dev = resolve_device(device)
    pop = _population_of(_mutant_population(n, lam, seed))
    packed, _ = eval_vectors(n)
    args = _launch_args(pop, packed, dev)
    sched = CK.schedule(*args[:3], args[-1], device=dev) \
        if dev.type == "cuda" else None

    def run_unfused():
        outw = CK.simulate_population(*args, schedule=sched)
        CS.decode_words(outw).cpu()

    def run_fused():
        CK.fused_eval_uint(*args, schedule=sched).cpu()

    row = {"bench": "evolve_fused_kernel", "n": n, "lam": lam}
    for name, fn in (("unfused", run_unfused), ("fused", run_fused)):
        fn()                                   # build outside the timer
        row[f"{name}_evals_per_s"] = round(lam / _time(fn, reps), 1)
    row["fused_vs_unfused"] = round(row["fused_evals_per_s"]
                                    / row["unfused_evals_per_s"], 3)
    return row


def roofline_rows(combos) -> list[dict]:
    """Analytic roofline placement per kernel design, per workload shape
    (plus one padded multi-tenant fleet launch) — see
    `repro_torch.roofline.kernel_model` for the traffic model."""
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.roofline.kernel_model import (CircuitShape,
                                                   fleet_roofline,
                                                   roofline_row,
                                                   variant_rows)
    rows = []
    for (n, lam) in combos:
        pop = _population_of(_mutant_population(n, lam, 0))
        packed, _ = eval_vectors(n)
        depth = int(CS.gate_levels(pop.in0, pop.in1, pop.n_inputs).max(
            initial=0))
        shape = CircuitShape(P=pop.op.shape[0], G=pop.op.shape[1],
                             n_in=pop.n_inputs, W=2 * packed.shape[1],
                             n_out=pop.outputs.shape[1], depth=depth)
        for v in variant_rows(shape):
            rows.append({"bench": "kernel_roofline", "n": n, "lam": lam, **v})
    # a 4-tenant serving-fleet launch at max_batch=1024 (32 words/tenant)
    tenant_shapes = [CircuitShape(P=1, G=g, n_in=f, W=32, n_out=o)
                     for g, f, o in ((180, 21, 64), (340, 30, 32),
                                     (260, 11, 32), (260, 11, 32))]
    rl, eff = fleet_roofline(tenant_shapes)
    row = roofline_row("fleet_megakernel", rl)
    rows.append({"bench": "kernel_roofline", "variant": row.pop("variant"),
                 "tenants": len(tenant_shapes), **row,
                 "padding_efficiency": round(eff, 3)})
    return rows


def measure_tnn_objective(dataset: str, pop_size: int, reps: int,
                          device=None) -> dict:
    from repro_torch.evolve.problems import build_tnn_problem
    dev = resolve_device(device)
    prob = build_tnn_problem(dataset, epochs=4 if QUICK else 12,
                             cgp_iters=60 if QUICK else 500,
                             pcc_samples=4000 if QUICK else 30000,
                             device=dev)
    rng = np.random.default_rng(0)
    pop = np.stack([rng.integers(0, prob.domains) for _ in range(pop_size)])
    return {"bench": "evolve_tnn_objective", "dataset": dataset,
            "pop": pop_size, "n_genes": int(prob.domains.shape[0]),
            "device": str(dev),
            "evals_per_s": round(
                pop_size / _time(lambda: prob.objective(pop), reps), 1)}


def measure_campaign(reps: int) -> dict:
    p = build_synth_problem()
    cfg = CampaignConfig(n_islands=4, pop_size=16, n_epochs=4,
                         gens_per_epoch=4, migrate_k=2, seed=0)

    def run():
        with tempfile.TemporaryDirectory() as d:
            Campaign(p.domains, p.objective, cfg, checkpoint_dir=d,
                     name=p.name).run()

    t = _time(run, reps)
    gens = cfg.n_islands * cfg.total_generations
    return {"bench": "evolve_campaign", "islands": cfg.n_islands,
            "pop": cfg.pop_size, "generations": gens,
            "wall_s": round(t, 3), "gens_per_s": round(gens / t, 1),
            "fitness_evals_per_s": round(
                gens * cfg.pop_size / t, 1)}


def measure_parallel_campaign(epochs: int, wait_ms: float = 1.0) -> dict:
    """Serial vs 2- vs 4-worker epoch stepping on one expensive objective.

    Each mode steps the *same* campaign shape for `epochs` epochs after a
    warm-up epoch (executor spawn + worker problem builds stay out of the
    timed region).  The objective blocks ``wait_ms`` per evaluated row —
    the device-dispatch stand-in (`build_synth_problem(wait_ms=...)`), so
    the rows measure the executor's overlap, not the host's core count.
    Parallel workers keep per-worker memo caches, so they lose the
    cross-island dedup hits the serial memo gets — the measured speedup is
    net of that.
    """
    from repro_torch.evolve.problems import ProblemSpec

    spec = ProblemSpec("synth", {"n_genes": 10, "domain": 6,
                                 "wait_ms": wait_ms})
    row = {"bench": "evolve_parallel", "islands": 4, "pop": 16,
           "gens_per_epoch": 5, "epochs": epochs, "wait_ms": wait_ms}
    gens = 4 * 5 * epochs
    for workers in (0, 2, 4):
        p = spec.build()
        cfg = CampaignConfig(n_islands=4, pop_size=16,
                             n_epochs=epochs + 1, gens_per_epoch=5,
                             migrate_k=2, seed=0, workers=workers)
        with Campaign(p.domains, p.objective, cfg, name=p.name,
                      problem_spec=spec) as c:
            c.step_epoch()                     # warm-up: spawn + init
            t0 = time.perf_counter()
            for _ in range(epochs):
                c.step_epoch()
            t = time.perf_counter() - t0
        key = "serial" if workers == 0 else f"workers{workers}"
        row[f"{key}_wall_s"] = round(t, 3)
        row[f"{key}_gens_per_s"] = round(gens / t, 1)
    row["speedup_2w"] = round(row["workers2_gens_per_s"]
                              / row["serial_gens_per_s"], 3)
    row["speedup_4w"] = round(row["workers4_gens_per_s"]
                              / row["serial_gens_per_s"], 3)
    return row


def measure_zoo_compile(device=None) -> dict:
    """Cold vs warm zoo build on a tiny sweep (1 dataset x 2 variants).

    ``cold_s``   — empty emit dir + empty phase cache: trains, searches,
                   compiles and emits everything.
    ``warm_s``   — identical second invocation: every entry's manifest
                   fingerprint matches and its bundle verifies, so the
                   build is pure skip.
    ``forced_s`` — ``force=True`` with the phase cache still warm: full
                   campaign + emit per entry, but Phase 1/2 is a cache
                   load — isolates what the phase cache alone buys.
    """
    import shutil

    from repro_torch.compile.zoo import build_zoo, make_entries
    from repro_torch.evolve.problems import clear_phase_memo

    budgets = dict(islands=2, pop=8, epochs=1, gens_per_epoch=2,
                   migrate_k=1, tnn_epochs=2, cgp_points=1, cgp_iters=30,
                   pcc_samples=500)
    entries = make_entries(["breast_cancer"], ["base", "lean"],
                           device=str(resolve_device(device)), **budgets)
    emit = tempfile.mkdtemp(prefix="bench_zoo_emit_")
    cache = tempfile.mkdtemp(prefix="bench_zoo_phase_")
    row = {"bench": "zoo_compile", "entries": len(entries), **budgets}
    try:
        clear_phase_memo()      # genuinely cold: no in-process products
        t0 = time.perf_counter()
        rep = build_zoo(entries, emit, workers=1, cache_dir=cache)
        row["cold_s"] = round(time.perf_counter() - t0, 3)
        row["cold_built"] = len(rep["built"])
        t0 = time.perf_counter()
        rep = build_zoo(entries, emit, workers=1, cache_dir=cache)
        row["warm_s"] = round(time.perf_counter() - t0, 3)
        row["warm_cached"] = len(rep["cached"])
        clear_phase_memo()      # forced path rides the *disk* cache only
        t0 = time.perf_counter()
        build_zoo(entries, emit, workers=1, cache_dir=cache, force=True)
        row["forced_s"] = round(time.perf_counter() - t0, 3)
    finally:
        shutil.rmtree(emit, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)
    row["warm_speedup"] = round(row["cold_s"] / max(row["warm_s"], 1e-3), 1)
    row["forced_speedup"] = round(row["cold_s"] / row["forced_s"], 2)
    return row


def run(combos=None, device=None) -> list[dict]:
    reps = 3 if QUICK else 10
    combos = combos or ([(8, 32), (12, 32)] if QUICK
                        else [(8, 16), (8, 32), (8, 64), (12, 32)])
    rows = [measure_circuit(n, lam, reps, device=device)
            for (n, lam) in combos]
    rows += [measure_fused_kernel(n, lam, reps, device=device)
             for (n, lam) in combos]
    rows += roofline_rows(combos)
    rows.append(measure_tnn_objective("breast_cancer", 24, reps,
                                      device=device))
    rows.append(measure_campaign(max(1, reps // 3)))
    rows.append(measure_parallel_campaign(epochs=2 if QUICK else 4))
    rows.append(measure_zoo_compile(device=device))
    return rows


def main(out_path: str = OUT_PATH, device=None) -> None:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rows = run(device=dev)
    payload = {
        "bench": "evolve_campaign",
        "note": "campaign fitness evals/s by device and by gate-walk "
                "design, plus end-to-end island-campaign rate",
        "device": str(dev),
        "rows": rows,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    for r in rows:
        print(r)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    from benchmarks_torch.cgp_throughput import _cli
    main(*_cli(sys.argv[1:]))
