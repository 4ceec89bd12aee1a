"""Emit the reference's exact TNN of each Table-2 dataset as numpy arrays.

Trains each dataset's bespoke ternary network with the reference's
`train_tnn` at the settings of `repro.evolve.problems.build_tnn_problem`
(`n_hidden` from the Table-2 topology, 12 epochs, lr 1e-2, seed 0) and
writes `<name>_tnn.npz` — `w1t`, `w2t`, `thresholds`, `train_acc`,
`test_acc` and `name` — with a `.sha256` sidecar of its bytes.  The
PyTorch port reads these files with `repro_torch.core.tnn.load_tnn`
(until its own trainer lands) and never imports the reference;
`tests/test_torch_tnn.py` checks that the committed cardio file still
equals what the reference trains.

    PYTHONPATH=src python tools/emit_golden_tnn.py [out_dir]

`out_dir` defaults to `tests/golden_emit`; its `_tnn.npz` files are
replaced.
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.core.tnn import TNNTrainConfig, train_tnn  # noqa: E402
from repro.data.tabular import DATASETS, make_dataset  # noqa: E402

SUFFIX = "_tnn.npz"


def train(name: str):
    """The reference's exact TNN of `name` at the emitted settings."""
    return train_tnn(make_dataset(name), TNNTrainConfig(
        n_hidden=DATASETS[name].topology[1], epochs=12, lr=1e-2, seed=0))


def emit(out_dir: Path) -> list[Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in sorted(DATASETS):
        tnn = train(name)
        path = out_dir / f"{name}{SUFFIX}"
        with open(path, "wb") as f:
            np.savez(f, w1t=tnn.w1t, w2t=tnn.w2t, thresholds=tnn.thresholds,
                     train_acc=np.float64(tnn.train_acc),
                     test_acc=np.float64(tnn.test_acc), name=np.str_(name))
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        path.with_name(path.name + ".sha256").write_text(digest + "\n")
        print(f"{name}: hidden sizes {tnn.hidden_sizes()}, out_nnz "
              f"{tnn.out_nnz}, train/test acc {tnn.train_acc:.4f} / "
              f"{tnn.test_acc:.4f}, {path.stat().st_size} B")
        paths.append(path)
    return paths


if __name__ == "__main__":
    emit(Path(sys.argv[1]) if len(sys.argv) > 1
         else ROOT / "tests" / "golden_emit")
