"""Fig. 5: PCC Pareto trade-off + distance-error histograms.

Validated claims: (a) Pareto-optimal approximate PCCs trade eps_mde for
area monotonically; (b) moderate settings keep most operations error-free
(paper: 95.57% error-free at 12.6% area reduction for the 45x39 neuron).
The port of `benchmarks/fig5_pcc_pareto.py`: the PCC candidates and the
histogram's circuits run through the gate walk on `device`.
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import QUICK, tnn_libraries


def run(dataset: str = "arrhythmia", device=None) -> list[dict]:
    ds, tnn, pcc_lib, _ = tnn_libraries(dataset, device=device)
    rows = []
    for (npos, nneg) in pcc_lib.sizes():
        entries = pcc_lib.get(npos, nneg)
        exact_est = entries[0].est_area
        for rank, e in enumerate(entries):
            rows.append({
                "bench": "fig5", "dataset": dataset,
                "n_pos": npos, "n_neg": nneg, "rank": rank,
                "mde": round(e.mde, 4), "wcde": e.wcde,
                "correct_frac": round(e.correct_frac, 4),
                "rel_est_area": round(e.est_area / max(exact_est, 1e-9), 3),
                "synth_area_mm2": round(e.synth_area, 3),
            })
    # distance histogram for the largest PCC's mid-Pareto entry (Fig. 5b)
    biggest = max(pcc_lib.sizes(), key=lambda s: s[0] + s[1])
    entries = pcc_lib.get(*biggest)
    if len(entries) > 1:
        from repro_torch.core.pcc import sample_pair_domain
        e = entries[min(1, len(entries) - 1)]
        S = 20000 if QUICK else 200000
        pp, pn, x, z = sample_pair_domain(e.n_pos, e.n_neg, S, seed=0)
        rel = x >= z
        rel_a = e.pc_pos.eval_uint(pp, device=device)[:S] \
            >= e.pc_neg.eval_uint(pn, device=device)[:S]
        D = np.where(rel == rel_a, 0, x - z)
        hist, edges = np.histogram(D, bins=np.arange(-8.5, 9.5))
        rows.append({"bench": "fig5_hist", "dataset": dataset,
                     "n_pos": e.n_pos, "n_neg": e.n_neg,
                     "bins": edges[:-1].astype(int).tolist(),
                     "counts": hist.tolist()})
    return rows
