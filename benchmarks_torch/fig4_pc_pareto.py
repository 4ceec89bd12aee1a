"""Fig. 4: CGP-approximate popcounts vs the truncation baseline.

Validated claim: at matched mean arithmetic error, CGP circuits are
substantially smaller than truncation (paper: ~2x at eps_mae 0.5/1.1/1.9
for 8/16/47-bit popcounts).  The port of `benchmarks/fig4_pc_pareto.py`:
the truncation sweep and every CGP generation's children run through the
gate walk on `device`.
"""
from __future__ import annotations

from repro_torch.core.cgp import _truncation_stats
from repro_torch.core.circuits import eval_vectors, popcount_netlist
from benchmarks_torch.common import QUICK, get_pc_library


def run(sizes=None, device=None) -> list[dict]:
    sizes = sizes or ([8, 16] if QUICK else [8, 16, 47])
    rows = []
    for n in sizes:
        exact = popcount_netlist(n)
        ex_area = exact.cost().area_mm2
        packed, true = eval_vectors(n, n_samples=1 << 14)
        # truncation curve: all depths scored in one padded population pass
        trunc = {drop: (mae, area / ex_area)
                 for drop, (nl, mae, _, area)
                 in enumerate(_truncation_stats(n, packed, true, device),
                              start=1)}
        lib = get_pc_library(n, device=device)
        for nl in lib[1:]:
            mae = nl.meta["mae"]
            rel = nl.cost().area_mm2 / ex_area
            # cheapest truncation whose error is no worse than this circuit's
            cands = [a for m, a in trunc.values() if m <= mae + 1e-9]
            trunc_rel = min(cands, default=1.0)
            rows.append({
                "bench": "fig4", "n": n, "method": "cgp",
                "mae": round(mae, 3), "wcae": nl.meta["wcae"],
                "rel_area": round(rel, 3),
                "trunc_rel_area_at_error": round(trunc_rel, 3),
                "cgp_wins": bool(rel < trunc_rel + 1e-9),
            })
        for drop, (mae, rel) in sorted(trunc.items())[:6]:
            rows.append({"bench": "fig4", "n": n, "method": f"trunc{drop}",
                         "mae": round(mae, 3), "rel_area": round(rel, 3)})
    return rows
