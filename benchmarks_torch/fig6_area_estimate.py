"""Fig. 6: Phase-2 area estimate (sum of PC areas) vs modeled synthesis
(composed netlist incl. comparator).  Validated claim: good correlation,
with systematic underestimation for small PCCs (comparator ignored).

The port of `benchmarks/fig6_area_estimate.py`, which cannot be reused as
it is: it imports `benchmarks.common`, which imports `repro`.
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import tnn_libraries


def run(dataset: str = "cardio", device=None) -> list[dict]:
    _, _, pcc_lib, _ = tnn_libraries(dataset, device=device)
    est, synth = [], []
    rows = []
    for size in pcc_lib.sizes():
        for e in pcc_lib.get(size[0], size[1]):
            est.append(e.est_area)
            synth.append(e.synth_area)
            rows.append({"bench": "fig6", "size": f"{size[0]}x{size[1]}",
                         "est_area_mm2": round(e.est_area, 3),
                         "synth_area_mm2": round(e.synth_area, 3)})
    est, synth = np.array(est), np.array(synth)
    corr = float(np.corrcoef(est, synth)[0, 1]) if len(est) > 2 else 1.0
    rows.append({"bench": "fig6_summary", "dataset": dataset,
                 "n_points": len(est), "pearson_r": round(corr, 4),
                 "underestimates": int((est < synth).sum()),
                 "mean_ratio": round(float((synth / np.maximum(est, 1e-9)).mean()), 3)})
    return rows
