"""Emit the reference's Table-2/3 MLP baselines as numpy arrays.

Trains each Table-2 dataset's exact MLP and power-of-2 Ax MLP with the
reference's `train_mlp_baseline` at `benchmarks/table2_accuracy.py`'s
settings (hidden = `spec.mlp_topology[1]`, 15 epochs, lr 5e-3, seed 0,
8-bit weights) and writes one `mlp_baselines.npz` with, for each
`<dataset>_<exact|pow2>`, the integer weights (`_w1`, `_w2`), `_test_acc`
and the `cost("adc4")` `_area_mm2` and `_power_mw`, plus a `.sha256`
sidecar of its bytes.  The PyTorch port's tests and `chip_smoke.py` read
it and never import the reference.

    PYTHONPATH=src python tools/emit_golden_mlp.py [out_dir]

`out_dir` defaults to `tests/golden_emit`; its `mlp_baselines.npz` is
replaced.
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.core.baselines import train_mlp_baseline  # noqa: E402
from repro.data.tabular import DATASETS, make_dataset  # noqa: E402

NAME = "mlp_baselines.npz"
MODES = {"exact": False, "pow2": True}
EPOCHS = 15


def train(name: str, pow2: bool):
    """The reference's baseline of `name` at the emitted settings."""
    return train_mlp_baseline(make_dataset(name),
                              hidden=DATASETS[name].mlp_topology[1],
                              pow2=pow2, epochs=EPOCHS)


def emit(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name in sorted(DATASETS):
        for mode, pow2 in MODES.items():
            mlp = train(name, pow2)
            cost = mlp.cost("adc4")
            key = f"{name}_{mode}"
            arrays[f"{key}_w1"], arrays[f"{key}_w2"] = mlp.weights_int
            arrays[f"{key}_test_acc"] = np.float64(mlp.test_acc)
            arrays[f"{key}_area_mm2"] = np.float64(cost.area_mm2)
            arrays[f"{key}_power_mw"] = np.float64(cost.power_mw)
            print(f"{key}: test acc {mlp.test_acc:.4f}, area "
                  f"{cost.area_mm2:.3f} mm^2, power {cost.power_mw:.4f} mW")
    path = out_dir / NAME
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    path.with_name(path.name + ".sha256").write_text(digest + "\n")
    print(f"wrote {path} ({path.stat().st_size} B)")
    return path


if __name__ == "__main__":
    emit(Path(sys.argv[1]) if len(sys.argv) > 1
         else ROOT / "tests" / "golden_emit")
