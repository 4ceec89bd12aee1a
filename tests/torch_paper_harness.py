"""Shared set-up of the `tests/test_torch_paper_*.py` files.

Both harnesses — the reference's `benchmarks/` and the port's
`benchmarks_torch/` — sit at the repo root, outside `src/`, so this module
puts the root on `sys.path`.  The tests shrink both the same way, never
the data: CGP to `CGP_POINTS` tau points x `CGP_ITERS` generations, the
PCC libraries to `PCC_SAMPLES` samples, NSGA-II to `NSGA_POP` x
`NSGA_GENERATIONS`.  To hold everything downstream of QAT bit for bit,
both harnesses' TNN caches are seeded with the same golden TNN
(`tests/golden_emit/<ds>_tnn.npz`, the reference's trainer at 12 epochs,
lr 1e-2, seed 0), and the MLP baselines of Table 3 with the golden
integer weights (`tests/golden_emit/mlp_baselines.npz`).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as RCOM  # noqa: E402
import benchmarks_torch.common as PCOM  # noqa: E402

EMIT_DIR = ROOT / "tests" / "golden_emit"
CGP_POINTS = 1
CGP_ITERS = 12
PCC_SAMPLES = 400
NSGA_POP = 8
NSGA_GENERATIONS = 3
TNN_ACC_TOL = 0.05     # QAT columns: the TNN's test accuracy
MLP_ACC_TOL = 0.03     # and the MLP baselines'


def golden_tnns(name: str):
    """The golden TNN of `name` as the reference's and the port's
    `TrainedTNN`."""
    from repro.core.tnn import TrainedTNN
    from repro_torch.core.tnn import load_tnn

    got = load_tnn(EMIT_DIR / f"{name}_tnn.npz")
    ref = TrainedTNN(w1t=got.w1t.copy(), w2t=got.w2t.copy(),
                     thresholds=got.thresholds.copy(),
                     train_acc=got.train_acc, test_acc=got.test_acc,
                     name=got.name)
    return ref, got


def seed_tnn_caches(monkeypatch, names) -> None:
    """Both harnesses' `get_trained_tnn` return the golden TNNs."""
    from repro.data.tabular import make_dataset as ref_dataset
    from repro_torch.data.tabular import make_dataset as port_dataset

    for name in names:
        ref, got = golden_tnns(name)
        monkeypatch.setitem(RCOM._TNN_CACHE, (name, 0),
                            (ref_dataset(name), ref))
        monkeypatch.setitem(PCOM._TNN_CACHE, ("cpu", name, 0),
                            (port_dataset(name), got))


def shrink_libraries(monkeypatch) -> None:
    """Both harnesses' CGP and PCC budgets cut, their caches emptied."""
    for com in (RCOM, PCOM):
        real_cgp, real_pcc = com.evolve_pc_library, com.build_pcc_library

        def cgp(n, n_points, max_iters, seed, _real=real_cgp, **kw):
            return _real(n, n_points=CGP_POINTS, max_iters=CGP_ITERS,
                         seed=seed, **kw)

        def pcc(sizes, pc_libs, n_samples, seed, _real=real_pcc, **kw):
            return _real(sizes, pc_libs, n_samples=PCC_SAMPLES, seed=seed,
                         **kw)

        monkeypatch.setattr(com, "evolve_pc_library", cgp)
        monkeypatch.setattr(com, "build_pcc_library", pcc)
        monkeypatch.setattr(com, "_PC_CACHE", {})


def shrink_nsga(monkeypatch, *modules) -> None:
    """Each bench module's `NSGA2Config` cut to NSGA_POP x
    NSGA_GENERATIONS."""
    for mod in modules:
        real = mod.NSGA2Config

        def cfg(pop_size, n_generations, seed, _real=real):
            return _real(pop_size=NSGA_POP, n_generations=NSGA_GENERATIONS,
                         seed=seed)

        monkeypatch.setattr(mod, "NSGA2Config", cfg)


def golden_mlps(monkeypatch, ref_mod, port_mod) -> None:
    """`train_mlp_baseline` in both bench modules returns the golden
    integer weights (what the MLP's QAT would give where the trajectories
    hold), so that the cost columns compare exactly."""
    from repro.core.baselines import TrainedMLP as RefMLP
    from repro_torch.core.baselines import TrainedMLP as PortMLP

    with np.load(EMIT_DIR / "mlp_baselines.npz") as f:
        fix = {k: f[k] for k in f.files}

    def make(cls):
        def train(ds, hidden, *, pow2=False, **kw):
            mode = "pow2" if pow2 else "exact"
            return cls(weights_int=[fix[f"{ds.name}_{mode}_w1"],
                                    fix[f"{ds.name}_{mode}_w2"]],
                       test_acc=float(fix[f"{ds.name}_{mode}_test_acc"]),
                       pow2=pow2, in_bits=4, w_bits=8)
        return train

    monkeypatch.setattr(ref_mod, "train_mlp_baseline", make(RefMLP))
    monkeypatch.setattr(port_mod, "train_mlp_baseline", make(PortMLP))


def table2_pair(name: str):
    """Table 2's row of `name` from each harness, training its own TNN and
    MLP, and the TNNs they trained."""
    from benchmarks import table2_accuracy as R
    from benchmarks_torch import table2_accuracy as P

    (ref,), (got,) = R.run([name]), P.run([name], device="cpu")
    return ref, got, RCOM._TNN_CACHE[(name, 0)][1], \
        PCOM._TNN_CACHE[("cpu", name, 0)][1]


def check_table2_row(ref: dict, got: dict) -> None:
    """The paper's columns and the topology equal; the accuracies (QAT
    columns) within their tolerances."""
    assert got.keys() == ref.keys()
    for k in ("bench", "dataset", "paper_tnn", "paper_mlp", "paper_delta",
              "topology"):
        assert got[k] == ref[k], k
    assert abs(got["tnn_acc"] - ref["tnn_acc"]) <= TNN_ACC_TOL
    assert abs(got["mlp_acc"] - ref["mlp_acc"]) <= MLP_ACC_TOL
    assert abs(got["delta"] - ref["delta"]) <= TNN_ACC_TOL + MLP_ACC_TOL
    assert abs(got["delta"] - (got["mlp_acc"] - got["tnn_acc"])) < 1e-3


def check_same_tnn(ref, got) -> None:
    np.testing.assert_array_equal(got.w1t, ref.w1t)
    np.testing.assert_array_equal(got.w2t, ref.w2t)
    assert got.test_acc == ref.test_acc


VARIATION_AWARE = ("aware_clean", "aware_mean", "aware_p5")


def variation_pair(name: str):
    from benchmarks import variation_robustness as R
    from benchmarks_torch import variation_robustness as P

    return R.run([name]), P.run([name], device="cpu")


def check_variation_vanilla(ref: list, got: list) -> None:
    """Every column but the variation-aware trainings' equal."""
    assert [r["sigma"] for r in got] == [0.02, 0.05, 0.10]
    for a, b in zip(ref, got):
        assert b.keys() == a.keys()
        for k in a:
            if k not in VARIATION_AWARE + ("aware_helps",):
                assert b[k] == a[k], k


def check_variation_aware(ref: list, got: list) -> None:
    """The variation-aware columns within the TNN's tolerance."""
    for a, b in zip(ref, got):
        for k in VARIATION_AWARE:
            assert abs(b[k] - a[k]) <= TNN_ACC_TOL, (k, a[k], b[k])
        if all(b[k] == a[k] for k in VARIATION_AWARE):
            assert b["aware_helps"] == a["aware_helps"]
