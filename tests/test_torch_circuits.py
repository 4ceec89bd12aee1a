"""The port's netlists, builders, cost and vector sets against the reference.

`repro_torch.core.circuits` keeps the reference's numpy builders, liveness
and EGFET cost, and simulates through `kernels.dispatch` (on the CPU here,
the plain PyTorch version of the gate walk).  Everything is held bit for
bit against `repro.core.circuits` and `repro.hw.egfet` on the same inputs;
floats compare with `==`.
"""
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import circuits as RC  # noqa: E402
from repro.core import tnn as RT  # noqa: E402
from repro.hw import egfet as RE  # noqa: E402
from repro_torch.core import circuits as PC  # noqa: E402
from repro_torch.core import tnn as PT  # noqa: E402
from repro_torch.hw import egfet as PE  # noqa: E402
from repro_torch.kernels import cuda_circuit_sim as CK  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402

FIELDS = ("op", "in0", "in1", "outputs")


def _same_netlist(a, b):
    assert (a.n_inputs, a.name, a.meta) == (b.n_inputs, b.name, b.meta)
    for k in FIELDS:
        got, want = getattr(b, k), getattr(a, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _cost(c):
    return (c.area_mm2, c.power_mw)


def _port_pop(pop):
    return PC.NetlistPopulation(pop.n_inputs, pop.op, pop.in0, pop.in1,
                                pop.outputs)


def test_egfet_cost_model_equals_reference():
    assert PE.GATE_AREA_MM2 == RE.GATE_AREA_MM2
    assert PE.GATE_POWER_UW == RE.GATE_POWER_UW
    for g in RE.Gate:
        assert _cost(PE.gate_cost(int(g))) == _cost(RE.gate_cost(int(g)))
    for kind in ("adc4", "abc"):
        assert _cost(PE.interface_cost(274, kind)) == \
            _cost(RE.interface_cost(274, kind))
    with pytest.raises(ValueError):
        PE.interface_cost(3, "flash")
    for mw in (0.5, 2.0, 9.0, 20.0, 31.0):
        assert PE.power_source(mw) == RE.power_source(mw)
    a, b = PE.HwCost(1.5, 0.25), RE.HwCost(1.5, 0.25)
    assert ((a + a).scale(3.0).area_cm2, (a + a).scale(3.0).power_mw) == \
        ((b + b).scale(3.0).area_cm2, (b + b).scale(3.0).power_mw)
    np.testing.assert_array_equal(PC.GATE_AREA_VEC, RC.GATE_AREA_VEC)
    np.testing.assert_array_equal(PC.GATE_POWER_VEC, RC.GATE_POWER_VEC)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 52, 130])
def test_builders_equal_reference(n):
    _same_netlist(RC.popcount_netlist(n), PC.popcount_netlist(n))
    for drop in sorted({1, n // 3, n - 2} & set(range(1, n - 1))):
        _same_netlist(RC.truncated_popcount_netlist(n, drop),
                      PC.truncated_popcount_netlist(n, drop))
    _same_netlist(RC.comparator_geq_netlist(PC.popcount_width(n)),
                  PC.comparator_geq_netlist(PC.popcount_width(n)))
    assert PC.popcount_width(n) == RC.popcount_width(n)
    m = max(1, n // 2)
    _same_netlist(
        RC.compose_pcc(RC.popcount_netlist(n), RC.truncated_popcount_netlist(
            m + 2, 1), n, m + 2),
        PC.compose_pcc(PC.popcount_netlist(n), PC.truncated_popcount_netlist(
            m + 2, 1), n, m + 2))
    nl, ref = PC.popcount_netlist(n), RC.popcount_netlist(n)
    np.testing.assert_array_equal(nl.active_mask(), ref.active_mask())
    assert _cost(nl.cost()) == _cost(ref.cost()) and nl.area() == ref.area()


@pytest.mark.parametrize("sizes", [(0, 0), (0, 1), (0, 5), (1, 0), (4, 0),
                                   (1, 1), (3, 5), (52, 130)])
def test_hidden_exact_netlist_equals_reference(sizes):
    a, b = RT.hidden_exact_netlist(*sizes), PT.hidden_exact_netlist(*sizes)
    _same_netlist(a, b)
    assert _cost(a.cost()) == _cost(b.cost())


@pytest.mark.parametrize("n", [1, 3, 6, 16, 17, 40])
def test_vector_sets_equal_reference(n):
    packed, true = RC.eval_vectors(n, n_samples=3000, seed=n)
    got_packed, got_true = PC.eval_vectors(n, n_samples=3000, seed=n)
    np.testing.assert_array_equal(got_packed, packed)
    np.testing.assert_array_equal(got_true, true)
    np.testing.assert_array_equal(PC.popcount_of_packed(packed),
                                  RC.popcount_of_packed(packed))
    rng = np.random.default_rng(n)
    vecs = rng.random((2, 200, n)) < 0.5          # a leading batch axis
    np.testing.assert_array_equal(PC.pack_vectors(vecs),
                                  RC.pack_vectors(vecs))


@pytest.mark.parametrize("seed", range(4))
def test_random_populations_simulate_as_reference(seed):
    rng = np.random.default_rng(seed)
    n_in, G, n_out, P = 3 + seed * 3, 30 + 20 * seed, 1 + seed * 2, 2 + seed
    ref = RC.random_netlist_population(rng, n_in, G, n_out, P)
    port = _port_pop(ref)
    packed, true = RC.eval_vectors(n_in, n_samples=1000)
    np.testing.assert_array_equal(port.eval_uint(packed, device="cpu"),
                                  ref.eval_uint(packed))
    np.testing.assert_array_equal(port.simulate(packed, device="cpu"),
                                  ref.simulate(packed))
    per_ind = np.random.default_rng(seed + 9).integers(
        0, 2 ** 63, size=(P, n_in, 3), dtype=np.uint64)
    np.testing.assert_array_equal(port.eval_uint(per_ind, device="cpu"),
                                  ref.eval_uint(per_ind))
    for got, want in zip(port.pc_errors(packed, true, device="cpu"),
                         ref.pc_errors(packed, true)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.active_masks(), ref.active_masks())
    np.testing.assert_array_equal(port.areas(), ref.areas())
    for p in range(P):
        nl, rnl = port.netlist(p), ref.netlist(p)
        np.testing.assert_array_equal(nl.eval_uint(packed, device="cpu"),
                                      rnl.eval_uint(packed))
        assert _cost(nl.cost()) == _cost(rnl.cost())


def test_random_population_generator_equals_reference():
    a = RC.random_netlist_population(np.random.default_rng(5), 7, 50, 4, 6)
    b = PC.random_netlist_population(np.random.default_rng(5), 7, 50, 4, 6)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    with pytest.raises(ValueError):
        PC.random_netlist_population(np.random.default_rng(5), 3, 5, 9, 2)


@pytest.mark.parametrize("n", [5, 12, 20])
def test_padded_population_pc_errors_equal_reference(n):
    """Heterogeneous gate counts, CONST0-padded by `from_netlists`."""
    nls_r = [RC.popcount_netlist(n)] + [RC.truncated_popcount_netlist(n, d)
                                        for d in range(1, n - 1, 2)]
    nls_p = [PC.popcount_netlist(n)] + [PC.truncated_popcount_netlist(n, d)
                                        for d in range(1, n - 1, 2)]
    ref = RC.NetlistPopulation.from_netlists(nls_r)
    port = PC.NetlistPopulation.from_netlists(nls_p)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    packed, true = RC.eval_vectors(n, n_samples=4000)
    for got, want in zip(port.pc_errors(packed, true, device="cpu"),
                         ref.pc_errors(packed, true)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(D.population_pc_errors(port, packed, true,
                                                devices=["cpu"]),
                         ref.pc_errors(packed, true)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.areas(), ref.areas())
    sub, rsub = port.take(np.array([2, 0, 2])), ref.take(np.array([2, 0, 2]))
    np.testing.assert_array_equal(sub.eval_uint(packed, device="cpu"),
                                  rsub.eval_uint(packed))
    assert PC.pc_error(nls_p[1], packed, true, device="cpu") == \
        RC.pc_error(nls_r[1], packed, true)


def test_pc_errors_take_device_words():
    """The vector set may come as int32 word tensors uploaded once (what
    CGP does), with the same errors as from the uint64 numpy words."""
    from repro_torch.kernels import circuit_sim as CS

    pop = PC.NetlistPopulation.from_netlists(
        [PC.popcount_netlist(9), PC.truncated_popcount_netlist(9, 3)])
    packed, true = PC.eval_vectors(9)
    words = CS.words_tensor(CS.pack_words32(packed), "cpu")
    got = pop.pc_errors(words, torch.from_numpy(true), device="cpu")
    for g, w in zip(got, pop.pc_errors(packed, true, device="cpu")):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="true counts"):
        pop.pc_errors(packed, true[:-1], device="cpu")


def test_schedule_take_equals_the_gathered_rows_schedule():
    """`Schedule.take` gathers `rank` and `program` rows and keeps the
    depth and widest level; each gathered row equals that row's own."""
    rng = np.random.default_rng(11)
    pop = RC.random_netlist_population(rng, 5, 60, 3, 6)
    plan = D.check_plan(pop.op, pop.in0, pop.in1, pop.outputs, 5)
    lib = CK.schedule(*plan[:3], 5, device="cpu")
    rows = [3, 3, 0, 5]
    taken = lib.take(torch.tensor(rows))
    assert (taken.depth, taken.width) == (lib.depth, lib.width)
    assert torch.equal(taken.rank, lib.rank[rows])
    assert torch.equal(taken.program, lib.program[rows])
    for i, r in enumerate(rows):
        own = CK.schedule(*(a[r:r + 1] for a in plan[:3]), 5, device="cpu")
        assert torch.equal(taken.rank[i:i + 1], own.rank)
        np.testing.assert_array_equal(
            taken.starts[i, : own.depth + 1].numpy(), own.starts[0].numpy())
        assert (taken.starts[i, own.depth:] == own.starts[0, -1]).all()
    assert lib.take(np.array(rows)).rank.shape == (4, 60)


@pytest.mark.parametrize("per_individual", [False, True])
def test_population_eval_takes_device_words(per_individual):
    """Word planes may come as int32 tensors of uint32 words (packed on the
    device), shared or one a row, with the reference's decoded outputs."""
    from repro_torch.kernels import circuit_sim as CS

    rng = np.random.default_rng(2)
    ref = RC.random_netlist_population(rng, 4, 30, 2, 3)
    packed = rng.integers(0, 2 ** 63, size=(3, 4, 2), dtype=np.uint64) \
        if per_individual else RC.eval_vectors(4)[0]
    words = CS.words_tensor(CS.pack_words32(packed), "cpu")
    got = D.population_eval_pop(_port_pop(ref), words, devices=["cpu"])
    np.testing.assert_array_equal(got, ref.eval_uint(packed))


def test_simulation_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nl = PC.popcount_netlist(3)
    packed, true = PC.eval_vectors(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nl.eval_uint(packed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nl.population().pc_errors(packed, true)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CK.schedule(nl.op[None], nl.in0[None], nl.in1[None], 3)
    with pytest.raises(ValueError, match="input rows"):
        nl.eval_uint(packed[:2], device="cpu")


def test_launch_counts_are_exact_under_threads():
    """Launches from several threads: the counters are taken under a
    lock, so no increment is lost."""
    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            futures = [ex.submit(lambda: [CK._count(counts, "k")
                                          for _ in range(2000)])
                       for _ in range(16)]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
