"""Phases 2 and 3's machinery of the port against the reference.

`repro_torch.core.pcc` simulates the PC candidates through the port's gate
walk (the plain version on the CPU here) and keeps the reference's
sampling, pair statistics and Pareto selection; `repro_torch.core.nsga2`
is the reference's numpy code copied.  Both must give the reference's
libraries and archives bit for bit; floats compare with `==`.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import circuits as RC  # noqa: E402
from repro.core import nsga2 as RN  # noqa: E402
from repro.core import pcc as RP  # noqa: E402
from repro_torch.core import circuits as PC  # noqa: E402
from repro_torch.core import nsga2 as PN  # noqa: E402
from repro_torch.core import pcc as PP  # noqa: E402


def _pc_libs(C, sizes):
    """Per size: the exact popcount and truncated ones, `mae` in meta."""
    libs = {}
    for n in sizes:
        nls = [C.popcount_netlist(n)] + [C.truncated_popcount_netlist(n, d)
                                         for d in range(1, n - 1, 2)]
        for nl in nls:
            nl.meta["mae"] = float(nl.meta.get("drop", 0)) / 2
        libs[n] = nls
    return libs


def _entry(e):
    return (e.n_pos, e.n_neg, e.pc_pos.name, e.pc_neg.name, e.est_area,
            e.mde, e.wcde, e.correct_frac)


@pytest.mark.parametrize("sizes", [[(3, 5), (5, 3), (6, 6)],
                                   [(1, 4), (9, 2)], [(12, 20)]])
def test_build_pcc_library_equals_reference(sizes):
    ns = sorted({k for s in sizes for k in s})
    ref = RP.build_pcc_library(sizes, _pc_libs(RC, ns[:-1]), n_samples=3000,
                               seed=4, max_per_size=4)
    got = PP.build_pcc_library(sizes, _pc_libs(PC, ns[:-1]), n_samples=3000,
                               seed=4, max_per_size=4, device="cpu")
    assert got.sizes() == ref.sizes() and len(got) == len(ref)
    for size in ref.sizes():
        assert [_entry(e) for e in got.get(*size)] == \
            [_entry(e) for e in ref.get(*size)]
        for a, b in zip(ref.get(*size), got.get(*size)):
            assert a.synth_area == b.synth_area
            np.testing.assert_array_equal(b.compose().op, a.compose().op)


def test_pc_pareto_and_pair_evaluation_equal_reference():
    ref_lib, got_lib = _pc_libs(RC, [11])[11], _pc_libs(PC, [11])[11]
    assert [nl.name for nl in PP.pc_pareto(got_lib)] == \
        [nl.name for nl in RP.pc_pareto(ref_lib)]
    assert PP.evaluate_pcc_pair(got_lib[2], got_lib[1], 11, 11,
                                n_samples=2000, seed=3, device="cpu") == \
        RP.evaluate_pcc_pair(ref_lib[2], ref_lib[1], 11, 11, n_samples=2000,
                             seed=3)
    for a, b in zip(PP.sample_pair_domain(7, 4, 500, 1),
                    RP.sample_pair_domain(7, 4, 500, 1)):
        np.testing.assert_array_equal(a, b)


def _zdt_like(X):
    """A two-objective integer problem with a known trade-off."""
    f0 = X[:, 0] / 9.0
    g = 1.0 + X[:, 1:].sum(axis=1) / (9.0 * (X.shape[1] - 1))
    return np.stack([f0, g * (1.0 - np.sqrt(f0 / g))], axis=1)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_nsga2_equals_reference(seed, dedup):
    domains = np.array([10, 4, 7, 3, 10])
    seed_pop = np.zeros((1, 5), dtype=np.int64)
    ref = RN.nsga2(domains, _zdt_like, RN.NSGA2Config(
        pop_size=20, n_generations=12, seed=seed, dedup_eval=dedup),
        seed_population=seed_pop)
    got = PN.nsga2(domains, _zdt_like, PN.NSGA2Config(
        pop_size=20, n_generations=12, seed=seed, dedup_eval=dedup),
        seed_population=seed_pop)
    np.testing.assert_array_equal(got.pareto_x, ref.pareto_x)
    np.testing.assert_array_equal(got.pareto_f, ref.pareto_f)
    assert got.history == ref.history


def test_nsga2_driver_resumes_from_encoded_rng():
    """The stepwise driver, the RNG codecs and the bounded memo: a run
    restored mid-stream continues as the reference's uninterrupted run."""
    domains = np.array([6, 6, 6, 6])
    cfg = PN.NSGA2Config(pop_size=12, n_generations=6, seed=2)
    drv = PN.NSGA2Driver(domains, _zdt_like, cfg,
                         evaluate=PN._memoized(_zdt_like, maxsize=8))
    st = drv.init_state()
    for _ in range(3):
        st = drv.step(st)
    back = drv.restore_state(st.pop, st.F, st.generation,
                             PN.encode_rng_state(st.rng), st.history)
    for _ in range(3):
        back = drv.step(back)
    assert drv.evaluate.cache_info()["evictions"] > 0
    ref = RN.nsga2(domains, _zdt_like, RN.NSGA2Config(
        pop_size=12, n_generations=6, seed=2))
    px, pf = PN.extract_front(back.pop, back.F)
    np.testing.assert_array_equal(px, ref.pareto_x)
    np.testing.assert_array_equal(pf, ref.pareto_f)
    assert PN.decode_rng_state(PN.encode_rng_state(st.rng)).random() == \
        RN.decode_rng_state(RN.encode_rng_state(st.rng)).random()
