"""The port's dispatch layer against `repro.kernels.dispatch`.

Same numpy inputs through both; the port runs on explicit CPU devices
(its plain PyTorch versions), the reference on its `np`/`swar`/`pallas`
backends.  Results must be equal integer for integer, including word-axis
and population-axis splits over two devices and a multi-tenant launch
with gate-count, feature and width skew.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import circuits as C  # noqa: E402
from repro.kernels import circuit_sim as RCS  # noqa: E402
from repro.kernels import dispatch as RD  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402

CPU2 = ("cpu", "cpu")


def _bits(rng, *shape):
    return (rng.random(shape) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("devices", [("cpu",), CPU2])
@pytest.mark.parametrize("S", [1, 33, 200])
def test_program_eval_words_matches_reference(devices, S):
    rng = np.random.default_rng(S)
    pop = C.random_netlist_population(rng, 7, 30, 4, 1)
    words32 = RCS.pack_bits32(_bits(rng, S, 7))
    plan = (pop.op, pop.in0, pop.in1, pop.outputs)
    got = D.program_eval_words(*plan, words32, 7, devices=devices)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, RD.program_eval_words(*plan, words32, 7, backend="np"))
    np.testing.assert_array_equal(
        got, RD.program_eval_words(*plan, words32, 7, backend="swar"))
    # an int32 bit-pattern tensor plane gives the same answer
    tensor_words = torch.from_numpy(words32.view(np.int32))
    np.testing.assert_array_equal(
        D.program_eval_words(*plan, tensor_words, 7, devices=devices), got)


@pytest.mark.parametrize("per_individual", [False, True])
def test_population_eval_split_over_two_devices(per_individual):
    rng = np.random.default_rng(11)
    pop = C.random_netlist_population(rng, 6, 25, 3, 5)
    bits = _bits(rng, 5, 150, 6) if per_individual else _bits(rng, 150, 6)
    packed = C.pack_vectors(bits)
    want = RD.population_eval_uint(pop.op, pop.in0, pop.in1, pop.outputs,
                                   packed, 6, backend="np")
    for devices in (("cpu",), CPU2):
        np.testing.assert_array_equal(
            D.population_eval_pop(pop, packed, devices=devices), want)
    np.testing.assert_array_equal(
        want, RD.population_eval_pop(pop, packed, backend="pallas"))


def _fleet_case(rng):
    """Tenants with skewed gate counts, feature counts, output widths and
    batch widths (one gateless, one with an empty batch)."""
    shapes = [(3, 12, 2, 40), (9, 55, 4, 130), (5, 0, 3, 64), (2, 7, 1, 0),
              (7, 30, 6, 1)]
    plans, words = [], []
    for n_in, G, n_out, S in shapes:
        pop = C.random_netlist_population(rng, n_in, G, n_out, 1)
        plans.append((pop.op[0], pop.in0[0], pop.in1[0], pop.outputs[0],
                      n_in))
        words.append(RCS.pack_bits32(_bits(rng, S, n_in)))
    return plans, words


def test_fleet_eval_words_matches_reference_megakernel():
    rng = np.random.default_rng(2024)
    plans, words = _fleet_case(rng)
    got = D.fleet_eval_words(plans, words, device="cpu")
    want = RD.fleet_eval_words(plans, words, backend="pallas")
    assert len(got) == len(want) == len(plans)
    for t, (g, w, plane) in enumerate(zip(got, want, words)):
        assert g.dtype == np.int64 and g.shape == (plane.shape[1] * 32,)
        np.testing.assert_array_equal(g, w, err_msg=f"tenant {t}")
        # padding never leaks: each tenant equals its own single dispatch
        op, in0, in1, outputs, n_in = plans[t]
        alone = D.program_eval_words(op[None], in0[None], in1[None],
                                     outputs[None], plane, n_in,
                                     devices=("cpu",))[0]
        np.testing.assert_array_equal(g, alone, err_msg=f"tenant {t}")


def test_fleet_eval_words_edges():
    rng = np.random.default_rng(5)
    plans, words = _fleet_case(rng)
    assert D.fleet_eval_words([], [], device="cpu") == []
    empty = D.fleet_eval_words(plans[3:4], words[3:4], device="cpu")
    assert empty[0].shape == (0,)
    with pytest.raises(ValueError):
        D.fleet_eval_words(plans, words[:-1], device="cpu")
    with pytest.raises(ValueError):               # plane rows != n_inputs
        D.fleet_eval_words(plans[:1], words[1:2], device="cpu")


def test_check_plan_rejects_bad_plans():
    op = np.array([[5, 7]], np.int16)
    ok = (op, np.array([[0, 2]]), np.array([[1, 0]]), np.array([[3]]))
    D.check_plan(*ok, 2)
    with pytest.raises(ValueError, match="feed-forward"):
        D.check_plan(op, np.array([[2, 0]]), ok[2], ok[3], 2)
    with pytest.raises(ValueError, match="opcode"):
        D.check_plan(np.array([[13, 5]]), *ok[1:], 2)
    with pytest.raises(ValueError, match="output"):
        D.check_plan(*ok[:3], np.array([[4]]), 2)
    with pytest.raises(ValueError):
        D.check_plan(op, ok[1][:, :1], *ok[2:], 2)


def test_replica_devices_need_cuda_or_an_explicit_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.replica_devices(0)
    assert D.replica_devices(3, devices=CPU2) == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        D.replica_devices(-1, devices=CPU2)
    with pytest.raises(ValueError):
        D.replica_devices(0, devices=())


def test_no_device_means_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    pop = C.random_netlist_population(rng, 3, 4, 1, 1)
    words32 = RCS.pack_bits32(_bits(rng, 10, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.program_eval_words(pop.op, pop.in0, pop.in1, pop.outputs,
                             words32, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.fleet_eval_words([(pop.op[0], pop.in0[0], pop.in1[0],
                             pop.outputs[0], 3)], [words32])
