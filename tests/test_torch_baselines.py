"""The port's MLP baselines held against `repro.core.baselines` on the CPU.

* The cost model: `mlp_hw_cost` and `TrainedMLP.cost` of the golden
  integer weights (`tests/golden_emit/mlp_baselines.npz`, written by
  `tools/emit_golden_mlp.py`) equal the reference's `HwCost` exactly, with
  and without the ADC interface, exact and pow2; `PAPER_TABLE3` equal.
* The straight-through quantizers' forward codes equal the reference's on
  a seeded grid that holds the +-2^-4 cutoff, the float32 roundings of
  the points 2^(k + 1/2) where `round(log2)` steps, and the points where
  `w * 127` ends in .5 (round half to even in both).  The port decides
  the pow2 exponent by comparison with the float32 values where the
  reference's `round(log2(m))` steps; over every float32 in [2^-3, 1] it
  equals XLA's, which is one float32 off the true steps at 2^-2.5 and
  2^-1.5 (and `torch.log2` differs from both there).
* One step from identical parameters and batch: loss within 1e-6
  relative, gradients within 1e-6 * max|g|.  With pow2 weights a hidden
  pre-activation can cancel to exactly 0 in one framework and to ~1e-8 in
  the other, and the ReLU's gate then differs (whitewine and
  breast_cancer's first batch), so rows with a pre-activation within 1e-6
  of 0 are left out of the batch there.
* `train_mlp_baseline` at the golden settings (15 epochs, lr 5e-3, seed
  0): the integer weights of redwine equal the golden file in both modes;
  on every dataset the test accuracy is within `ACC_TOL` of it (the
  trajectories part where a gradient cancels to the noise floor, as QAT's
  do; the table is in ROADMAP.md, Queue 3, from `tools/mlp_tolerance.py`),
  and the cost equals the golden cost whenever the weights are equal.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as RB  # noqa: E402
from repro.data import tabular as RD  # noqa: E402
from repro.hw import egfet as RE  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from repro_torch.data import tabular as PD  # noqa: E402

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden_emit" \
    / "mlp_baselines.npz"
DATASETS = sorted(RD.DATASETS)
MODES = {"exact": False, "pow2": True}
ACC_TOL = 0.03          # test accuracy, port against the golden file
GRAD_TOL = 1e-6         # of max |g|
KINK = 1e-6             # pre-activations this close to 0 are left out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as fix:
        return {k: fix[k] for k in fix.files}


def _weights(golden, name, mode):
    return [golden[f"{name}_{mode}_w1"], golden[f"{name}_{mode}_w2"]]


def _same_cost(a, b) -> bool:
    return (a.area_mm2, a.power_mw) == (b.area_mm2, b.power_mw)


@pytest.mark.parametrize("interface", [None, "adc4"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mlp_hw_cost_equals_reference(golden, mode, interface):
    pow2 = MODES[mode]
    for name in DATASETS:
        w = _weights(golden, name, mode)
        want = RB.mlp_hw_cost(w, 4, 8, pow2, interface)
        got = PB.mlp_hw_cost(w, 4, 8, pow2, interface)
        assert isinstance(want, RE.HwCost)
        assert _same_cost(got, want), (name, got, want)
        mlp = PB.TrainedMLP(weights_int=w, test_acc=0.0, pow2=pow2,
                            in_bits=4, w_bits=8)
        ref = RB.TrainedMLP(weights_int=w, test_acc=0.0, pow2=pow2,
                            in_bits=4, w_bits=8)
        assert _same_cost(mlp.cost(interface), ref.cost(interface))


def test_cost_pieces_equal_reference():
    for fn in ("adder_cost", "relu_cost"):
        for width in range(0, 20):
            assert _same_cost(getattr(PB, fn)(width), getattr(RB, fn)(width))
    for w in range(-130, 131):
        for bits in (4, 8):
            assert _same_cost(PB.shift_add_multiplier_cost(w, bits),
                              RB.shift_add_multiplier_cost(w, bits))
    for n in range(0, 40):
        assert _same_cost(PB.accumulator_tree_cost(n, 12),
                          RB.accumulator_tree_cost(n, 12))


def test_paper_table3_equal():
    assert PB.PAPER_TABLE3 == RB.PAPER_TABLE3


def _grid(rng) -> np.ndarray:
    """Seeded latents with the quantizers' edge points mixed in."""
    f32 = np.float32
    below = np.nextafter(f32(2.0 ** -4), f32(0))
    steps = [f32(2.0 ** (k + 0.5)) for k in (-3, -2, -1)]
    halves = [f32((k + 0.5) / 127) for k in range(-128, 128)]
    edges = [0.0, 2.0 ** -4, below, np.nextafter(f32(2.0 ** -4), f32(1)),
             2.0 ** -3, 1.0, 1.5, 127 / 127, 128 / 127, *steps, *halves]
    edges = np.array(edges, dtype=np.float32)
    body = np.concatenate([rng.normal(0, 0.3, 4000),
                           rng.uniform(-1.5, 1.5, 4000)]).astype(np.float32)
    return np.concatenate([edges, -edges, body])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ste_forward_codes_equal_reference(mode):
    w = _grid(np.random.default_rng(0))
    if MODES[mode]:
        want = np.asarray(RB._pow2_ste(jnp.asarray(w)))
        got = PB._pow2_ste(torch.from_numpy(w)).numpy()
    else:
        want = np.asarray(RB._int_ste(jnp.asarray(w), 8))
        got = PB._int_ste(torch.from_numpy(w), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_pow2_exponent_over_every_float32():
    lo, hi = (np.float32(v).view(np.int32) for v in (2.0 ** -3, 1.0))
    bits = np.arange(lo, hi + 1, dtype=np.int32)
    off_true = []
    for s in range(0, bits.size, 1 << 22):
        m = bits[s:s + (1 << 22)].view(np.float32)
        want = np.asarray(jnp.round(jnp.log2(jnp.asarray(m))))
        got = PB._pow2_exponent(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)
        exact = np.round(np.log2(m.astype(np.float64)))
        off_true.extend(m[got != exact].tolist())
    assert off_true == [float(np.float32(2.0 ** -2.5)),
                        float(np.float32(0.3535534))]


def _batch(ds, rng, pow2, w1):
    """The first batch of the reference's first epoch; with pow2 weights,
    less the rows whose hidden pre-activation sits within `KINK` of 0."""
    xq = RB._quant_input_4bit(ds.x_train).astype(np.float32)
    idx = rng.permutation(xq.shape[0])[:64]
    x, y = xq[idx], ds.y_train[idx].astype(np.int32)
    if pow2:
        q = np.asarray(RB._pow2_ste(jnp.asarray(w1)), dtype=np.float64)
        keep = (np.abs(x.astype(np.float64) @ q) >= KINK).all(axis=1)
        x, y = x[keep], y[keep]
    return x, y


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", DATASETS)
def test_one_step_gradients_match_reference(name, mode):
    import jax

    pow2 = MODES[mode]
    ds = RD.make_dataset(name)
    H, F, C = (RD.DATASETS[name].mlp_topology[1], ds.spec.n_features,
               ds.spec.n_classes)
    rng = np.random.default_rng(0)
    w1 = rng.normal(0, 0.3, (F, H)).astype(np.float32)
    w2 = rng.normal(0, 0.3, (H, C)).astype(np.float32)
    x, y = _batch(ds, rng, pow2, w1)
    assert x.shape[0] >= 48
    quant = RB._pow2_ste if pow2 else (lambda w: RB._int_ste(w, 8))

    def loss(p):
        h = jax.nn.relu(jnp.asarray(x) @ quant(p["w1"]))
        lp = jax.nn.log_softmax(h @ quant(p["w2"]), axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1))

    want_loss, want = jax.value_and_grad(loss)(
        {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)})
    got_loss, got = PB.loss_and_grads(
        {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)},
        torch.from_numpy(x), torch.from_numpy(y).long(), pow2)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-6 * abs(
        float(want_loss))
    gmax = max(float(jnp.abs(g).max()) for g in want.values())
    for k in ("w1", "w2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=GRAD_TOL * gmax)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["redwine", "cardio", "breast_cancer"])
def test_training_matches_golden(golden, name, mode):
    pow2 = MODES[mode]
    mlp = PB.train_mlp_baseline(PD.make_dataset(name),
                                PD.DATASETS[name].mlp_topology[1],
                                pow2=pow2, device="cpu")
    key = f"{name}_{mode}"
    assert abs(mlp.test_acc - float(golden[f"{key}_test_acc"])) <= ACC_TOL
    same = all(np.array_equal(a, b) for a, b in
               zip(mlp.weights_int, _weights(golden, name, mode)))
    if name == "redwine":
        assert same
    if same:
        c = mlp.cost("adc4")
        assert (c.area_mm2, c.power_mw) == (
            float(golden[f"{key}_area_mm2"]),
            float(golden[f"{key}_power_mw"]))
    assert [w.dtype for w in mlp.weights_int] == [np.int32, np.int32]
    assert mlp.weights_int[0].shape == (PD.DATASETS[name].n_features,
                                        PD.DATASETS[name].mlp_topology[1])


def test_training_on_cpu_is_deterministic():
    ds = PD.make_dataset("redwine")
    a, b = (PB.train_mlp_latents(ds, 2, pow2=True, epochs=2, device="cpu")
            for _ in range(2))
    for k in ("w1", "w2"):
        assert torch.equal(a[k], b[k])
