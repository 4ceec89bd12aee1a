"""The circuit-accurate TNN half and its data of the port, against the reference.

* `make_dataset` of the five Table-2 datasets, the ABC thresholds and the
  binarized inputs (compared in float32, as JAX compares) equal the
  reference's arrays.
* The golden `_tnn.npz` files match their sidecars, and the cardio file is
  what the reference's trainer gives now.
* `TNNApproxProblem` on the cardio and arrhythmia golden TNNs: `objective`
  equals the reference's `objective` and `_eval_one` bit for bit on seeded
  populations (arrhythmia's 16 scores of 0-3 tie often, and the first
  class must win as in numpy), `decode` and a short `optimize` equal too.
  The PC libraries come from the exact and truncated popcount builders, so
  no CGP run is needed.
"""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import tnn_paper as RCFG  # noqa: E402
from repro.core import circuits as RC  # noqa: E402
from repro.core import pcc as RP  # noqa: E402
from repro.core import tnn as RT  # noqa: E402
from repro.core.nsga2 import NSGA2Config as RNCfg  # noqa: E402
from repro.core.ternary import abc_binarize as ref_binarize  # noqa: E402
from repro.core.ternary import abc_fit_thresholds as ref_fit  # noqa: E402
from repro.data import tabular as RD  # noqa: E402
from repro_torch.configs import tnn_paper as PCFG  # noqa: E402
from repro_torch.core import circuits as PC  # noqa: E402
from repro_torch.core import pcc as PP  # noqa: E402
from repro_torch.core import ternary as PTe  # noqa: E402
from repro_torch.core import tnn as PT  # noqa: E402
from repro_torch.core.nsga2 import NSGA2Config as PNCfg  # noqa: E402
from repro_torch.data import tabular as PD  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EMIT_DIR = ROOT / "tests" / "golden_emit"
DATASETS = sorted(RD.DATASETS)


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_and_abc_equal_reference(name):
    ref, got = RD.make_dataset(name), PD.make_dataset(name)
    assert got.spec == PD.DATASETS[name] and got.spec.__dict__ == \
        ref.spec.__dict__
    for k in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    thr = PTe.abc_fit_thresholds(got.x_train)
    assert thr.dtype == np.float32
    np.testing.assert_array_equal(thr, ref_fit(ref.x_train))
    for x in (got.x_train, got.x_test):
        xb = PTe.abc_binarize(x, thr, device="cpu")
        np.testing.assert_array_equal(xb.numpy(),
                                      np.asarray(ref_binarize(x, thr)))
    assert PCFG.get_tnn_config(name).__dict__ == \
        RCFG.get_tnn_config(name).__dict__


@pytest.mark.parametrize("name", DATASETS)
def test_golden_tnn_matches_its_sidecar(name):
    path = EMIT_DIR / f"{name}_tnn.npz"
    digest = (EMIT_DIR / f"{name}_tnn.npz.sha256").read_text().strip()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest
    tnn = PT.load_tnn(path)
    assert tnn.name == name
    assert tnn.topology == RD.DATASETS[name].topology
    xb = PTe.abc_binarize(PD.make_dataset(name).x_train, tnn.thresholds,
                          device="cpu").numpy()
    ref = RT.TrainedTNN(tnn.w1t, tnn.w2t, tnn.thresholds, 0.0, 0.0)
    np.testing.assert_array_equal(PT.predict_exact(tnn, xb),
                                  RT.predict_exact(ref, xb))
    assert float((PT.predict_exact(tnn, xb) == PD.make_dataset(
        name).y_train).mean()) == tnn.train_acc


def test_golden_cardio_tnn_is_what_the_reference_trains():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from emit_golden_tnn import train
    finally:
        sys.path.remove(str(ROOT / "tools"))
    ref = train("cardio")
    got = PT.load_tnn(EMIT_DIR / "cardio_tnn.npz")
    for k in ("w1t", "w2t", "thresholds"):
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert (got.train_acc, got.test_acc) == (ref.train_acc, ref.test_acc)


def test_tnn_from_arrays_refuses_bad_weights():
    tnn = PT.load_tnn(EMIT_DIR / "cardio_tnn.npz")
    with pytest.raises(ValueError, match="ternary"):
        PT.tnn_from_arrays(tnn.w1t * 2, tnn.w2t, tnn.thresholds)
    with pytest.raises(ValueError, match="chain"):
        PT.tnn_from_arrays(tnn.w1t, tnn.w2t[:-1], tnn.thresholds)


def _pc_libs(C, tnn, drops):
    """Per popcount size of `tnn`: the exact circuit and truncated ones
    dropping `drops` inputs, `mae` in meta as the Phase-1 libraries hold."""
    sizes = {k for p, n in tnn.hidden_sizes() if p and n for k in (p, n)}
    libs = {}
    for n in sorted(sizes | {max(tnn.out_nnz, 1)}):
        nls = [C.popcount_netlist(n)] + [C.truncated_popcount_netlist(n, d)
                                         for d in drops if d < n - 1]
        for nl in nls:
            nl.meta["mae"] = float(nl.meta.get("drop", 0)) / 2
        libs[n] = nls
    return libs


def _problems(name, drops):
    """The reference's problem and the port's, from the same golden TNN."""
    tnn = PT.load_tnn(EMIT_DIR / f"{name}_tnn.npz")
    ref_tnn = RT.TrainedTNN(tnn.w1t, tnn.w2t, tnn.thresholds, tnn.train_acc,
                            tnn.test_acc, name)
    ds = RD.make_dataset(name)
    sizes = sorted({(p, n) for p, n in tnn.hidden_sizes() if p and n})
    out_n = max(tnn.out_nnz, 1)
    r_libs, p_libs = _pc_libs(RC, tnn, drops), _pc_libs(PC, tnn, drops)
    r_pcc = RP.build_pcc_library(sizes, r_libs, n_samples=3000)
    p_pcc = PP.build_pcc_library(sizes, p_libs, n_samples=3000, device="cpu")
    ref = RT.TNNApproxProblem(
        tnn=ref_tnn, pcc_lib=r_pcc, pc_out_lib=RP.pc_pareto(r_libs[out_n]),
        xbin=np.asarray(ref_binarize(ds.x_train, tnn.thresholds)),
        y=ds.y_train)
    got = PT.TNNApproxProblem(
        tnn=tnn, pcc_lib=p_pcc, pc_out_lib=PP.pc_pareto(p_libs[out_n]),
        xbin=PTe.abc_binarize(ds.x_train, tnn.thresholds, device="cpu"),
        y=ds.y_train, device="cpu")
    return ref, got


DROPS = {"cardio": (1, 2, 3, 4), "arrhythmia": (1, 8, 30)}


@pytest.fixture(scope="module", params=["cardio", "arrhythmia"])
def problems(request):
    return request.param, *_problems(request.param, DROPS[request.param])


def test_problem_caches_equal_reference(problems):
    _, ref, got = problems
    assert got.hidden_idx == ref.hidden_idx
    np.testing.assert_array_equal(got.domains(), ref.domains())
    np.testing.assert_array_equal(got.fixed_hbits, ref.fixed_hbits)
    assert len(got.hidden_bit_cache) == len(ref.hidden_bit_cache)
    for a, b in zip(ref.hidden_bit_cache, got.hidden_bit_cache):
        np.testing.assert_array_equal(b, a)
    assert (got.fixed_cost.area_mm2, got.fixed_cost.power_mw) == \
        (ref.fixed_cost.area_mm2, ref.fixed_cost.power_mw)


def test_objective_equals_reference_and_eval_one(problems):
    name, ref, got = problems
    rng = np.random.default_rng(7)
    pop = rng.integers(0, ref.domains()[None, :], size=(48, ref.n_genes))
    pop[0] = 0                     # every neuron's first candidate
    want = ref.objective(pop)
    F = got.objective(pop)
    assert F.dtype == np.float64
    np.testing.assert_array_equal(F, want)
    for i in (0, 1, 17, 47):
        assert tuple(F[i]) == got._eval_one(pop[i]) == ref._eval_one(pop[i])
    # a design's error is its decoded circuits' error on the training set
    xb = got.xbin
    pred = PT.predict_with_circuits(got.tnn, xb, *got.decode(pop[1]),
                                    device="cpu")
    assert F[1, 0] == 1.0 - float((pred == got.y).mean())
    if name == "arrhythmia":     # classes tie, and the first one must win
        w2 = got.tnn.w2t.astype(np.int64)
        h = (xb.astype(np.int64) @ got.tnn.w1t.astype(np.int64) >= 0)
        score = h @ (w2 == 1) + (1 - h) @ (w2 == -1)
        ties = (score == score.max(axis=1, keepdims=True)).sum(axis=1) > 1
        assert ties.mean() > 0.1


def test_decode_and_cost_equal_reference(problems):
    _, ref, got = problems
    x = np.array([d - 1 for d in ref.domains()])
    for a_list, b_list in zip(ref.decode(x), got.decode(x)):
        assert [nl.name for nl in a_list] == [nl.name for nl in b_list]
        for a, b in zip(a_list, b_list):
            np.testing.assert_array_equal(b.op, a.op)
    a, b = RT.tnn_hw_cost(ref.tnn, *ref.decode(x)), \
        PT.tnn_hw_cost(got.tnn, *got.decode(x))
    assert (a.area_mm2, a.power_mw) == (b.area_mm2, b.power_mw)
    ea, eb = RT.exact_netlists(ref.tnn), PT.exact_netlists(got.tnn)
    assert [nl.name for nl in ea[0] + ea[1]] == \
        [nl.name for nl in eb[0] + eb[1]]
    sub = got.xbin[:200]
    np.testing.assert_array_equal(
        PT.predict_with_circuits(got.tnn, sub, *got.decode(x), device="cpu"),
        RT.predict_with_circuits(ref.tnn, sub, *ref.decode(x)))
    np.testing.assert_array_equal(
        PT.predict_with_circuits(got.tnn, sub, *eb, device="cpu"),
        PT.predict_exact(got.tnn, sub))
    c, d = RT.argmax_cost(16, 2), PT.argmax_cost(16, 2)
    assert (c.area_mm2, c.power_mw) == (d.area_mm2, d.power_mw)


def test_optimize_equals_reference(problems):
    _, ref, got = problems
    r = ref.optimize(RNCfg(pop_size=12, n_generations=3, seed=1))
    g = got.optimize(PNCfg(pop_size=12, n_generations=3, seed=1))
    np.testing.assert_array_equal(g.pareto_x, r.pareto_x)
    np.testing.assert_array_equal(g.pareto_f, r.pareto_f)
    assert g.history == r.history
