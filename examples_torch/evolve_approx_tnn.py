"""The paper's full three-phase evolutionary approximation flow (Fig. 3),
followed by the deployment path the evolved winner actually ships through.

Phase 1 — CGP evolves approximate popcount circuits per size.
Phase 2 — Pareto-optimal popcount-compare combinations (distance metric D).
Phase 3 — NSGA-II assigns approximate units per neuron: area vs accuracy.
          With --campaign the single NSGA-II run becomes a resumable
          island-model campaign (repro_torch.evolve): independent islands with
          ring migration of Pareto elites, checkpointed every epoch.
Phase 4 — compile: the chosen Pareto design is lowered to one levelized
          gate IR, emitted as structural Verilog + EGFET report
          (artifacts/), and served as a batched sensor stream through the
          `CircuitProgram` on the device.

Phases 1 and 2 run population-parallel: every generation's lambda CGP
children are scored in one batched `NetlistPopulation` pass, the tau
schedule's independent runs share a thread pool on the CPU, and the PCC
library evaluates each candidate circuit once over a shared sample domain.

The port of `examples/evolve_approx_tnn.py`: QAT, every fitness call and
the served stream run on `--device` (default: the current CUDA device;
`cpu` runs the plain PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/evolve_approx_tnn.py [dataset]
          [--device cpu]
      PYTHONPATH=src python examples_torch/evolve_approx_tnn.py cardio \
          --campaign [--islands 4] [--ckpt-dir runs/cardio]
"""
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import tnn as T
from repro_torch.core.cgp import evolve_pc_library
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.pcc import build_pcc_library, pc_pareto
from repro_torch.core.ternary import abc_binarize
from repro_torch.data.tabular import make_dataset
from repro_torch.compile import CircuitProgram, egfet_report, \
    lower_classifier, write_artifacts
from repro_torch.serve.engine import CircuitServingEngine


def main(dataset: str = "cardio", campaign: bool = False, islands: int = 4,
         ckpt_dir: str | None = None, device=None) -> None:
    dev = resolve_device(device)
    ds = make_dataset(dataset)
    tnn = T.train_tnn(ds, T.TNNTrainConfig(
        n_hidden=ds.spec.topology[1], epochs=12, lr=1e-2), device=dev)
    print(f"[exact] acc={tnn.test_acc:.3f} sizes={tnn.hidden_sizes()}")

    # Phase 1: approximate popcount libraries for every size in the TNN
    sizes, pcc_sizes = set(), []
    for (p, n) in tnn.hidden_sizes():
        if p >= 1 and n >= 1:
            sizes.update([p, n])
            pcc_sizes.append((p, n))
    sizes.add(max(tnn.out_nnz, 1))
    pc_libs = {}
    t1 = time.perf_counter()
    for n in sorted(sizes):
        pc_libs[n] = evolve_pc_library(n, n_points=3, max_iters=500,
                                       device=dev)
        print(f"[phase1] pc{n}: {len(pc_libs[n])} circuits "
              f"(areas {[round(c.cost().area_mm2, 2) for c in pc_libs[n]]})")
    print(f"[phase1] evolved {sum(map(len, pc_libs.values()))} circuits over "
          f"{len(sizes)} sizes in {time.perf_counter() - t1:.1f}s "
          "(population-parallel fitness, threaded tau schedule)")

    # Phase 2: Pareto-optimal PCC combinations under the distance metric
    pcc_lib = build_pcc_library(sorted(set(pcc_sizes)), pc_libs,
                                n_samples=30000, device=dev)
    print(f"[phase2] PCC library: {len(pcc_lib)} Pareto entries over "
          f"{len(pcc_lib.sizes())} sizes")
    pc_out = pc_pareto(pc_libs[max(tnn.out_nnz, 1)])

    # Phase 3: NSGA-II integration
    xb_tr, xb_te = (abc_binarize(x, tnn.thresholds, device=dev).cpu().numpy()
                    for x in (ds.x_train, ds.x_test))
    prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                              xbin=xb_tr, y=ds.y_train, device=dev)
    if campaign:
        from repro_torch.evolve import Campaign, CampaignConfig
        seed_pop = np.zeros((1, prob.n_genes), dtype=np.int64)
        cfg = CampaignConfig(n_islands=islands, pop_size=24, n_epochs=8,
                             gens_per_epoch=5, migrate_k=2, seed=0,
                             device=str(dev))
        camp = Campaign(prob.domains(), prob.objective, cfg,
                        checkpoint_dir=ckpt_dir, seed_population=seed_pop,
                        name=f"tnn_{dataset}")
        cres = camp.run()
        if cres.resumed_from is not None:
            print(f"[phase3] resumed campaign from epoch "
                  f"{cres.resumed_from} checkpoint")
        pareto_x, pareto_f = cres.archive_x, cres.archive_f
        print(f"[phase3] island campaign: {islands} islands x "
              f"{cfg.total_generations} gens, archive {len(pareto_x)}")
    else:
        res = prob.optimize(NSGA2Config(pop_size=24, n_generations=40,
                                        seed=0))
        pareto_x, pareto_f = res.pareto_x, res.pareto_f

    hx, ox = T.exact_netlists(tnn)
    exact_area = T.tnn_hw_cost(tnn, hx, ox, interface=None).area_mm2
    print(f"[phase3] Pareto front ({len(pareto_x)} designs, "
          f"exact area {exact_area/100:.3f} cm^2):")
    best = None   # highest test accuracy, ties broken by smaller area
    for x, f in zip(pareto_x, pareto_f):
        hnl, onl = prob.decode(x)
        acc = float((T.predict_with_circuits(tnn, xb_te, hnl, onl,
                                             device=dev)
                     == ds.y_test).mean())
        area = T.tnn_hw_cost(tnn, hnl, onl, interface=None).area_mm2
        print(f"  test_acc={acc:.3f}  area={area/100:.3f} cm^2 "
              f"({area/exact_area:.0%} of exact)")
        if best is None or (acc, -area) > (best[0], -best[1]):
            best = (acc, area, hnl, onl)

    # Phase 4: compile the winner -> emit RTL + report -> serve a stream
    acc, area, hnl, onl = best
    cc = lower_classifier(tnn, hnl, onl)
    paths = write_artifacts(cc, "artifacts", base=f"tnn_{dataset}",
                            dataset=dataset)
    rep = egfet_report(cc)
    print(f"[compile] winner acc={acc:.3f}: {cc.ir.n_gates} gates, "
          f"depth {cc.ir.depth}, {rep['total_area_mm2']:.2f} mm^2, "
          f"{rep['total_power_mw']:.3f} mW ({rep['power_source']})")
    print(f"[emit] {paths['verilog']}  {paths['report']}")
    engine = CircuitServingEngine(CircuitProgram.from_classifier(cc,
                                                                 device=dev),
                                  max_batch=1024)
    engine.warmup()
    reps = max(1, 32768 // ds.x_test.shape[0])
    labels = engine.classify_stream(np.tile(ds.x_test, (reps, 1)))
    served_acc = float((labels == np.tile(ds.y_test, reps)).mean())
    s = engine.stats.summary()
    print(f"[serve] {s['n_readings']} readings at "
          f"{s['readings_per_s']:.0f} readings/s "
          f"(p50 {s['p50_ms']:.2f} ms/batch, served acc={served_acc:.3f})")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="cardio")
    ap.add_argument("--campaign", action="store_true",
                    help="run Phase 3 as a resumable island-model campaign")
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current CUDA device) or cpu")
    a = ap.parse_args()
    main(a.dataset, campaign=a.campaign, islands=a.islands,
         ckpt_dir=a.ckpt_dir, device=a.device)
