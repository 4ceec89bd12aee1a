"""The port's gate simulation held bit-exact against the JAX reference.

`repro_torch.kernels.circuit_sim` (the plain PyTorch versions) and the
CPU route of the CUDA wrappers in `cuda_circuit_sim` must give the same
words and integers as `repro.kernels.circuit_sim` (SWAR scan),
`repro.kernels.pallas_circuit_sim` (interpret mode here) and the numpy
`NetlistPopulation` on random populations, shared and per-individual word
planes and the degenerate shapes of the conformance suite.  Inputs come
from seeded numpy streams; every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import circuits as C  # noqa: E402
from repro.kernels import circuit_sim as RCS  # noqa: E402
from repro.kernels import pallas_circuit_sim as PS  # noqa: E402
from repro_torch.kernels import circuit_sim as CS  # noqa: E402
from repro_torch.kernels import cuda_circuit_sim as CK  # noqa: E402


def _bits(rng, *shape):
    return (rng.random(shape) < 0.5).astype(np.uint8)


def _plan(pop):
    return [torch.from_numpy(np.asarray(a, dtype=np.int32))
            for a in (pop.op, pop.in0, pop.in1, pop.outputs)]


def _as_i32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32).view(np.int32)


def _check_population(pop, packed, S):
    """Port words/ints == reference SWAR, Pallas and numpy evaluators."""
    words32 = RCS.pack_words32(packed)
    np.testing.assert_array_equal(CS.pack_words32(packed), words32)
    plan = _plan(pop)
    words = CS.words_tensor(words32, "cpu")
    op32 = pop.op.astype(np.int32)

    ref_words = _as_i32(RCS.simulate_population(
        op32, pop.in0, pop.in1, pop.outputs, words32, pop.n_inputs))
    got_words = CS.simulate_population(*plan, words, pop.n_inputs)
    np.testing.assert_array_equal(got_words.numpy(), ref_words)
    np.testing.assert_array_equal(_as_i32(PS.simulate_population(
        pop.op, pop.in0, pop.in1, pop.outputs, words32, pop.n_inputs)),
        ref_words)
    np.testing.assert_array_equal(
        CK.simulate_population(*plan, words, pop.n_inputs).numpy(),
        ref_words)

    ref = pop.eval_uint(packed)
    got = CS.population_eval_uint(*plan, words, pop.n_inputs).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, :S], np.asarray(
        RCS.population_eval_uint(op32, pop.in0, pop.in1, pop.outputs,
                                 words32, pop.n_inputs))[:, :S])
    np.testing.assert_array_equal(got, np.asarray(PS.population_eval_uint(
        pop.op, pop.in0, pop.in1, pop.outputs, words32, pop.n_inputs)))
    np.testing.assert_array_equal(
        CK.fused_eval_uint(*plan, words, pop.n_inputs).numpy(), got)


@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_random_populations_match_reference(seed, per_individual):
    rng = np.random.default_rng(1000 + seed)
    n_in = int(rng.integers(1, 9))
    G = int(rng.integers(0, 41))
    n_out = int(rng.integers(1, min(8, n_in + G) + 1))
    P = int(rng.integers(1, 7))
    S = int(rng.integers(1, 200))
    pop = C.random_netlist_population(rng, n_in, G, n_out, P)
    bits = _bits(rng, P, S, n_in) if per_individual else _bits(rng, S, n_in)
    _check_population(pop, C.pack_vectors(bits), S)


@pytest.mark.parametrize("n_in,n_gates,n_out,P,S", [
    (1, 0, 1, 1, 1), (2, 0, 2, 3, 5), (4, 1, 4, 2, 64), (3, 40, 1, 6, 65),
    (8, 16, 8, 4, 33)])
def test_degenerate_shapes_match_reference(n_in, n_gates, n_out, P, S):
    """Gateless plans, one-word batches, repeated taps, odd widths — the
    shapes `tests/test_conformance.py` pins for the reference."""
    rng = np.random.default_rng(99 + S)
    pop = C.random_netlist_population(rng, n_in, n_gates, n_out, P)
    _check_population(pop, C.pack_vectors(_bits(rng, S, n_in)), S)


@pytest.mark.parametrize("per_individual", [False, True])
def test_zero_width_word_plane_returns_empty(per_individual):
    rng = np.random.default_rng(7)
    pop = C.random_netlist_population(rng, 4, 10, 2, 3)
    shape = (3, 4, 0) if per_individual else (4, 0)
    words = torch.zeros(shape, dtype=torch.int32)
    plan = _plan(pop)
    assert CK.simulate_population(*plan, words, 4).shape == (3, 2, 0)
    assert CK.fused_eval_uint(*plan, words, 4).shape == (3, 0)
    assert CS.population_eval_uint(*plan, words, 4).shape == (3, 0)
    ref = np.asarray(PS.population_eval_uint(
        pop.op, pop.in0, pop.in1, pop.outputs,
        np.zeros(shape, np.uint32), 4))
    assert ref.shape == (3, 0)


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 65])
def test_pack_bits32_matches_reference(S):
    rng = np.random.default_rng(S)
    bits = _bits(rng, S, 5)
    got = CS.pack_bits32(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _as_i32(RCS.pack_bits32(bits)))


def test_pack_bits32_sign_bit():
    """Readings at s % 32 == 31 land in bit 31, the int32 sign bit."""
    rng = np.random.default_rng(31)
    bits = _bits(rng, 64, 3)
    bits[31::32] = 1
    got = CS.pack_bits32(torch.from_numpy(bits)).numpy()
    want = RCS.pack_bits32(bits)
    assert (want >= 2 ** 31).all()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert (got < 0).all()


def test_pc_errors_match_reference():
    rng = np.random.default_rng(5)
    pop = C.random_netlist_population(rng, 6, 30, 3, 5)
    packed = C.pack_vectors(_bits(rng, 128, 6))
    words32 = RCS.pack_words32(packed)
    true = rng.integers(0, 8, size=words32.shape[-1] * 32)
    mae, wcae = CS.population_pc_errors(
        *_plan(pop), CS.words_tensor(words32, "cpu"),
        torch.from_numpy(true), pop.n_inputs)
    ref_mae, ref_wcae = pop.pc_errors(packed, true)
    np.testing.assert_array_equal(mae.numpy(), ref_mae)
    np.testing.assert_array_equal(wcae.numpy(), ref_wcae)
    # the JAX twin reports float32 statistics of the same integers
    jmae, jwcae = RCS.population_pc_errors(
        pop.op.astype(np.int32), pop.in0, pop.in1, pop.outputs, words32,
        true.astype(np.int32), pop.n_inputs)
    np.testing.assert_allclose(mae.numpy(), np.asarray(jmae), rtol=1e-6)
    np.testing.assert_array_equal(wcae.numpy(), np.asarray(jwcae))


def test_wrappers_reject_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    pop = C.random_netlist_population(rng, 4, 6, 2, 2)
    plan = _plan(pop)
    words = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        CK.fused_eval_uint(plan[0].long(), *plan[1:], words, 4)
    with pytest.raises(TypeError):
        CK.fused_eval_uint(*plan, words.numpy(), 4)
    with pytest.raises(ValueError):               # word rows != n_inputs
        CK.fused_eval_uint(*plan, torch.zeros((5, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError):               # in0 shape != op shape
        CK.simulate_population(plan[0], plan[1][:, :3], plan[2], plan[3],
                               words, 4)
    with pytest.raises(ValueError):               # not contiguous
        CK.fused_eval_uint(*plan, torch.zeros((3, 4), dtype=torch.int32).T,
                           4)
    with pytest.raises(ValueError):               # no executor for `meta`
        CK.fused_eval_uint(*[p.to("meta") for p in plan],
                           words.to("meta"), 4)
