"""Fig. 8: NSGA-II convergence over generations (arrhythmia in the paper).

Validated claim: substantial progress within the first ~50 generations.
The port of `benchmarks/fig8_nsga2.py`: the fitness runs through the gate
walk on `device`.
"""
from __future__ import annotations

from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.ternary import abc_binarize
from repro_torch.core import tnn as T
from benchmarks_torch.common import QUICK, tnn_libraries


def run(dataset: str = None, device=None) -> list[dict]:
    dataset = dataset or ("cardio" if QUICK else "arrhythmia")
    ds, tnn, pcc_lib, pc_out = tnn_libraries(dataset, device=device)
    xb = abc_binarize(ds.x_train, tnn.thresholds, device=device).cpu().numpy()
    prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                              xbin=xb, y=ds.y_train, device=device)
    gens = 30 if QUICK else 200
    res = prob.optimize(NSGA2Config(pop_size=24 if QUICK else 40,
                                    n_generations=gens, seed=0))
    rows = []
    for g, best_err, best_area in res.history[:: max(1, gens // 20)]:
        rows.append({"bench": "fig8", "dataset": dataset, "generation": g,
                     "front_best_err": round(best_err, 4),
                     "front_best_area_mm2": round(best_area, 2)})
    first = res.history[0]
    last = res.history[-1]
    mid = res.history[min(len(res.history) - 1, max(1, gens // 4))]
    rows.append({"bench": "fig8_summary", "dataset": dataset,
                 "area_gen0": round(first[2], 2),
                 "area_quarter": round(mid[2], 2),
                 "area_final": round(last[2], 2),
                 "early_progress_frac": round(
                     (first[2] - mid[2]) / max(first[2] - last[2], 1e-9), 3)})
    return rows
