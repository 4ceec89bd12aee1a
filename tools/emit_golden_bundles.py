"""Emit the five golden classifiers as servable bundles + a fleet manifest.

Builds each Table-2 dataset's deterministic, untrained classifier
(`tests/test_golden.py::golden_classifier`, the designs whose labels on 96
pinned readings `tests/golden/<name>.npz` holds) through the reference
compiler, and writes `<name>_program.npz`, its `.sha256` sidecar and one
`fleet.json` row per classifier with the reference's own `save_program`
and `register_tenant`.  The PyTorch port serves this directory without
JAX; `tests/test_torch_artifact.py` checks that the committed bundles
still equal what the reference lowers.

    PYTHONPATH=src python tools/emit_golden_bundles.py [out_dir]

`out_dir` defaults to `tests/golden_emit`; its old bundles and manifest
are replaced.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro.compile import artifact as A  # noqa: E402
from repro.data.tabular import DATASETS  # noqa: E402
from test_golden import golden_classifier  # noqa: E402


def emit(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    for stale in [*out_dir.glob(f"*{A.PROGRAM_SUFFIX}*"),
                  A.manifest_path(out_dir)]:
        stale.unlink(missing_ok=True)
    manifest = None
    for name in sorted(DATASETS):
        cc, _ = golden_classifier(name)
        path = Path(A.save_program(cc, out_dir / f"{name}{A.PROGRAM_SUFFIX}"))
        manifest = A.register_tenant(out_dir, {
            "name": name,
            "program": str(path),
            "dataset": name,
            "n_features": cc.n_features,
            "n_classes": cc.n_classes,
            "n_gates": cc.ir.n_gates,
            "replicas": 1,
            "sha256": path.with_name(path.name + A.SHA_SUFFIX)
                          .read_text().strip(),
        })
        print(f"{name}: {cc.ir.n_gates} gates, depth {cc.ir.depth}, "
              f"{path.stat().st_size} B")
    return manifest


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "tests" / "golden_emit"
    print(emit(out))
