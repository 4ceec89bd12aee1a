"""Table 3: comparison against the state of the art, w/ and w/o the
sensor-processor interface cost (ADC for MLPs, ABC for our TNNs).

Validated claims: (a) our exact/approx TNNs beat the modeled MLP baselines
on area and power; (b) interface accounting flips the balance dramatically
(paper: >=6x area / >=19x power vs the best Ax MLP once ADC vs ABC is
counted); (c) every non-arrhythmia TNN fits the printed-harvester budget.
The port of `benchmarks/table3_sota.py`: the baselines train, and the
NSGA-II fitness and the front's accuracy run, on `device`.
"""
from __future__ import annotations

from repro_torch.core.baselines import PAPER_TABLE3, train_mlp_baseline
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core import tnn as T
from repro_torch.data.tabular import DATASETS
from repro_torch.hw.egfet import SENSOR_POWER_MW, power_source
from benchmarks_torch.common import QUICK, tnn_libraries
from benchmarks_torch.fig7_tnn_pareto import binarized


def run(datasets=None, device=None) -> list[dict]:
    datasets = datasets or (["breast_cancer", "cardio"] if QUICK
                            else list(DATASETS))
    rows = []
    for name in datasets:
        spec = DATASETS[name]
        ds, tnn, pcc_lib, pc_out = tnn_libraries(name, device=device)

        # --- baselines (modeled) ---
        mlp = train_mlp_baseline(ds, hidden=spec.mlp_topology[1],
                                 epochs=10 if QUICK else 15, device=device)
        mlp_pow2 = train_mlp_baseline(ds, hidden=spec.mlp_topology[1],
                                      pow2=True, epochs=10 if QUICK else 15,
                                      device=device)
        for label, m in (("exact_mlp[37]", mlp), ("ax_mlp_pow2[1,2]", mlp_pow2)):
            c0 = m.cost(interface=None)
            c1 = m.cost(interface="adc4")
            rows.append({"bench": "table3", "dataset": name, "design": label,
                         "acc": round(m.test_acc, 3),
                         "area_cm2": round(c0.area_cm2, 3),
                         "power_mw": round(c0.power_mw, 3),
                         "area_cm2_iface": round(c1.area_cm2, 3),
                         "power_mw_iface": round(c1.power_mw, 3),
                         "power_source": power_source(
                             c1.power_mw + SENSOR_POWER_MW)})

        # --- our exact TNN ---
        hx, ox = T.exact_netlists(tnn)
        for label, (hnl, onl, acc) in {
                "our_exact_tnn": (hx, ox, tnn.test_acc)}.items():
            c0 = T.tnn_hw_cost(tnn, hnl, onl, interface=None)
            c1 = T.tnn_hw_cost(tnn, hnl, onl, interface="abc")
            rows.append({"bench": "table3", "dataset": name, "design": label,
                         "acc": round(acc, 3),
                         "area_cm2": round(c0.area_cm2, 3),
                         "power_mw": round(c0.power_mw, 3),
                         "area_cm2_iface": round(c1.area_cm2, 3),
                         "power_mw_iface": round(c1.power_mw, 3),
                         "power_source": power_source(
                             c1.power_mw + SENSOR_POWER_MW)})

        # --- our approximate TNN (best iso-accuracy point) ---
        xb_tr, xb_te = binarized(ds, tnn, device)
        prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                                  xbin=xb_tr, y=ds.y_train, device=device)
        res = prob.optimize(NSGA2Config(pop_size=24 if QUICK else 40,
                                        n_generations=20 if QUICK else 100,
                                        seed=0))
        best = None
        for x, f in zip(res.pareto_x, res.pareto_f):
            hnl, onl = prob.decode(x)
            acc = float((T.predict_with_circuits(tnn, xb_te, hnl, onl,
                                                 device=device)
                         == ds.y_test).mean())
            c0 = T.tnn_hw_cost(tnn, hnl, onl, interface=None)
            if acc >= tnn.test_acc - 0.01:
                if best is None or c0.area_mm2 < best[1].area_mm2:
                    best = (acc, c0, T.tnn_hw_cost(tnn, hnl, onl, "abc"))
        if best:
            acc, c0, c1 = best
            rows.append({"bench": "table3", "dataset": name,
                         "design": "our_ax_tnn",
                         "acc": round(acc, 3),
                         "area_cm2": round(c0.area_cm2, 3),
                         "power_mw": round(c0.power_mw, 3),
                         "area_cm2_iface": round(c1.area_cm2, 3),
                         "power_mw_iface": round(c1.power_mw, 3),
                         "power_source": power_source(
                             c1.power_mw + SENSOR_POWER_MW)})

        # --- paper-published reference rows ---
        for design, (acc, area, power) in PAPER_TABLE3[name].items():
            rows.append({"bench": "table3_paper", "dataset": name,
                         "design": design, "acc": acc,
                         "area_cm2": area, "power_mw": power})
    return rows
