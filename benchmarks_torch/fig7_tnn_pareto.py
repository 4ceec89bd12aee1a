"""Fig. 7 (+ headline claims): NSGA-II approximate TNN area-accuracy Pareto.

Validated claims: (a) iso-accuracy approx TNNs cut area vs the exact TNN
(paper average: -41%); (b) allowing a 5% accuracy drop raises savings
(paper average: -67%).  The port of `benchmarks/fig7_tnn_pareto.py`: the
NSGA-II fitness and the front's test accuracy run through the gate walk on
`device`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.ternary import abc_binarize
from repro_torch.core import tnn as T
from benchmarks_torch.common import QUICK, tnn_libraries


def binarized(ds, tnn, device=None) -> tuple[np.ndarray, np.ndarray]:
    """The train and test splits ABC-binarized on `device`, on the host."""
    return tuple(abc_binarize(x, tnn.thresholds, device=device).cpu().numpy()
                 for x in (ds.x_train, ds.x_test))


def run(datasets=None, device=None) -> list[dict]:
    datasets = datasets or (["cardio", "breast_cancer", "redwine"] if QUICK
                            else ["arrhythmia", "breast_cancer", "cardio",
                                  "redwine", "whitewine"])
    rows = []
    iso_savings, drop5_savings = [], []
    for name in datasets:
        ds, tnn, pcc_lib, pc_out = tnn_libraries(name, device=device)
        xb_tr, xb_te = binarized(ds, tnn, device)
        prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                                  xbin=xb_tr, y=ds.y_train, device=device)
        res = prob.optimize(NSGA2Config(
            pop_size=24 if QUICK else 40,
            n_generations=25 if QUICK else 120, seed=0))
        hx, ox = T.exact_netlists(tnn)
        exact_cost = T.tnn_hw_cost(tnn, hx, ox, interface=None)
        best_iso, best_drop5 = 1.0, 1.0
        for x, f in zip(res.pareto_x, res.pareto_f):
            hnl, onl = prob.decode(x)
            test_acc = float((T.predict_with_circuits(tnn, xb_te, hnl, onl,
                                                      device=device)
                              == ds.y_test).mean())
            cost = T.tnn_hw_cost(tnn, hnl, onl, interface=None)
            rel = cost.area_mm2 / exact_cost.area_mm2
            rows.append({"bench": "fig7", "dataset": name,
                         "train_err": round(float(f[0]), 4),
                         "test_acc": round(test_acc, 4),
                         "area_cm2": round(cost.area_cm2, 4),
                         "power_mw": round(cost.power_mw, 4),
                         "rel_area": round(rel, 3)})
            if test_acc >= tnn.test_acc - 0.005:
                best_iso = min(best_iso, rel)
            if test_acc >= tnn.test_acc - 0.05:
                best_drop5 = min(best_drop5, rel)
        iso_savings.append(1 - best_iso)
        drop5_savings.append(1 - best_drop5)
        rows.append({"bench": "fig7_summary", "dataset": name,
                     "exact_acc": round(tnn.test_acc, 4),
                     "exact_area_cm2": round(exact_cost.area_cm2, 4),
                     "iso_acc_area_saving": round(1 - best_iso, 3),
                     "drop5_area_saving": round(1 - best_drop5, 3)})
    rows.append({"bench": "fig7_headline",
                 "avg_iso_saving": round(float(np.mean(iso_savings)), 3),
                 "avg_drop5_saving": round(float(np.mean(drop5_savings)), 3),
                 "paper_iso_saving": 0.41, "paper_drop5_saving": 0.67})
    return rows
