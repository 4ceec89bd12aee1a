"""Table 2: exact-TNN accuracy vs the exact-MLP baseline [37].

Validated claim: the TNN (1-bit inputs / ternary weights) stays within a
0-4% accuracy band of the 4-bit/8-bit MLP on every dataset.  The port of
`benchmarks/table2_accuracy.py`: both networks train on `device`.
"""
from __future__ import annotations

from repro_torch.core.baselines import train_mlp_baseline
from repro_torch.data.tabular import DATASETS
from benchmarks_torch.common import QUICK, get_trained_tnn


def run(datasets=None, device=None) -> list[dict]:
    rows = []
    datasets = datasets or list(DATASETS)
    for name in datasets:
        spec = DATASETS[name]
        ds, tnn = get_trained_tnn(name, device=device)
        mlp = train_mlp_baseline(ds, hidden=spec.mlp_topology[1],
                                 epochs=10 if QUICK else 15, device=device)
        rows.append({
            "bench": "table2", "dataset": name,
            "tnn_acc": round(tnn.test_acc, 3),
            "mlp_acc": round(mlp.test_acc, 3),
            "delta": round(mlp.test_acc - tnn.test_acc, 3),
            "paper_tnn": spec.paper_tnn_acc, "paper_mlp": spec.paper_mlp_acc,
            "paper_delta": round(spec.paper_mlp_acc - spec.paper_tnn_acc, 3),
            "topology": "x".join(map(str, spec.topology)),
        })
    return rows
