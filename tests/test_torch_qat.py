"""The port's ternary QAT held against `repro.core.tnn` on the CPU.

* The STE quantizers: forward values and backward masks exact, a value on
  the clip boundary (half the gradient in JAX) and latents between the
  float32 and float64 roundings of 1/3 included.
* `_loss_fn` and its gradients from the same numpy parameters and batch:
  loss within 1e-6 relative, gradients within 1e-6 * max|g|.  Both sum
  the matrix products in their own order, so the last bits differ.
* `adamw.apply_updates` fed the same gradients and state: parameters and
  moments within rtol 1e-6, atol 1e-7; `schedule` with warmup and cosine.
* `balance_zero_counts` on float32 and float64 latents: exact.
* `train_tnn` at the golden settings (`tools/emit_golden_tnn.py`: 12
  epochs, lr 1e-2, seed 0): the codes of arrhythmia, redwine and
  whitewine equal `tests/golden_emit/<ds>_tnn.npz`.  On breast_cancer and
  cardio some entries of dL/dw1 cancel to the noise floor (cardio's
  w1[13, 1] reads 2.2e-9 in JAX, -5.1e-11 in PyTorch); AdamW's first step
  g / (|g| + 1e-8) turns that into steps up to ~0.2 lr apart, and the
  trajectories part.  Neither framework can give the other's sum order,
  so there the TNN must be balanced and within 5 pp of the golden test
  accuracy.
* `search_tnn`'s tie-break, with `train_tnn` stubbed.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ternary as RTe  # noqa: E402
from repro.core import tnn as RT  # noqa: E402
from repro.data import tabular as RD  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch.core import ternary as PTe  # noqa: E402
from repro_torch.core import tnn as PT  # noqa: E402
from repro_torch.data import tabular as PD  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402

EMIT_DIR = Path(__file__).resolve().parents[1] / "tests" / "golden_emit"
DATASETS = sorted(RD.DATASETS)
F32_THIRD = float(np.float32(1 / 3))


def _latents(rng, shape):
    """Latent weights with the quantizers' edge values mixed in: 0, +-1
    (the STE window's edge), the float32 rounding of 1/3, a value between
    the two roundings, and values past 1."""
    w = rng.normal(0, 0.7, size=shape)
    edges = np.array([0.0, 1.0, -1.0, F32_THIRD, -F32_THIRD,
                      (1 / 3 + F32_THIRD) / 2, 1.5, -2.0])
    flat = w.reshape(-1)
    flat[: edges.size] = edges
    return w


def _grad(fn_jax, fn_torch, x, c):
    """d/dx sum(fn(x) * c) in both frameworks."""
    gj = jax.grad(lambda v: jnp.sum(fn_jax(v) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (fn_torch(xt) * torch.from_numpy(c)).sum().backward()
    return np.asarray(gj), xt.grad.numpy()


def test_ternary_ste_forward_and_mask_exact():
    rng = np.random.default_rng(0)
    w = _latents(rng, (64, 33)).astype(np.float32)
    c = rng.normal(size=w.shape).astype(np.float32)
    for thr in (PTe.TERNARY_THRESHOLD, 0.5):
        np.testing.assert_array_equal(
            PTe.ternarize(torch.from_numpy(w), thr).numpy(),
            np.asarray(RTe.ternarize(jnp.asarray(w), thr)))
        np.testing.assert_array_equal(
            PTe.ternary_ste(torch.from_numpy(w), thr).detach().numpy(),
            np.asarray(RTe.ternary_ste(jnp.asarray(w), thr)))
        gj, gt = _grad(lambda v: RTe.ternary_ste(v, thr),
                       lambda v: PTe.ternary_ste(v, thr), w, c)
        np.testing.assert_array_equal(gt, gj)
    # the float32 threshold: a latent just above 1/3 but at or below
    # float32(1/3) is a zero code
    assert PTe.ternarize(torch.tensor([F32_THIRD, np.nextafter(
        np.float32(F32_THIRD), np.float32(1))])).tolist() == [0.0, 1.0]


@pytest.mark.parametrize("F", [10, 16, 274])
def test_binary_step_ste_forward_and_mask_exact(F):
    rng = np.random.default_rng(F)
    gw = np.sqrt(np.float32(F))
    a = rng.integers(-F, F + 1, size=(64, 7)).astype(np.float32)
    a.reshape(-1)[:4] = [gw, -gw, 0.0, -0.0]      # on the clip boundary
    c = rng.normal(size=a.shape).astype(np.float32)
    gw_t = torch.tensor(gw)
    np.testing.assert_array_equal(
        PTe.binary_step_ste(torch.from_numpy(a), gw_t).detach().numpy(),
        np.asarray(RTe.binary_step_ste(jnp.asarray(a), jnp.float32(gw))))
    gj, gt = _grad(lambda v: RTe.binary_step_ste(v, jnp.float32(gw)),
                   lambda v: PTe.binary_step_ste(v, gw_t), a, c)
    np.testing.assert_array_equal(gt, gj)
    assert gj.reshape(-1)[0] == np.float32(0.5) * c.reshape(-1)[0] / gw


def _batch(name, seed=0, size=64):
    ds = RD.make_dataset(name)
    F, H, Cc = ds.spec.topology
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 0.7, (F, H)).astype(np.float32)
    w2 = rng.normal(0, 0.7, (H, Cc)).astype(np.float32)
    thr = RTe.abc_fit_thresholds(ds.x_train)
    xb = np.asarray(RTe.abc_binarize(ds.x_train, thr))
    idx = rng.permutation(xb.shape[0])[:size]
    return {"w1": w1, "w2": w2}, xb[idx], ds.y_train[idx].astype(np.int32), H


@pytest.mark.parametrize("name", DATASETS)
def test_loss_and_grads_match_reference(name):
    params, xb, y, H = _batch(name)
    loss, grads = jax.value_and_grad(RT._loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xb),
        jnp.asarray(y), RT.TNNTrainConfig(H).threshold, H)
    p_loss, p_grads = PT.loss_and_grads(
        PT.params_from_arrays(params, "cpu"), torch.from_numpy(xb),
        torch.from_numpy(y.astype(np.int64)), PT.TNNTrainConfig(H).threshold,
        H)
    assert abs(float(p_loss) - float(loss)) <= 1e-6 * abs(float(loss))
    g_max = max(float(jnp.abs(g).max()) for g in grads.values())
    for k in ("w1", "w2"):
        assert p_grads[k].dtype == torch.float32
        np.testing.assert_allclose(p_grads[k].numpy(), np.asarray(grads[k]),
                                   rtol=0, atol=1e-6 * g_max)


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2), dict(lr=3e-3, weight_decay=0.1, grad_clip=0.05),
    dict(lr=1e-3, grad_clip=None, warmup_steps=5, total_steps=40)])
@pytest.mark.parametrize("step", [0, 3, 37])
def test_adamw_apply_updates_match_reference(cfg, step):
    rng = np.random.default_rng(step)
    shapes = {"w1": (21, 3), "w2": (3, 3)}
    params = {k: rng.normal(0, 0.7, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.normal(0, 0.3, s).astype(np.float32)
             for k, s in shapes.items()}
    mu = {k: rng.normal(0, 0.05, s).astype(np.float32)
          for k, s in shapes.items()} if step else \
        {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    nu = {k: np.abs(rng.normal(0, 0.01, s)).astype(np.float32)
          for k, s in shapes.items()} if step else \
        {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    r_cfg, p_cfg = RA.AdamWConfig(**cfg), PA.AdamWConfig(**cfg)
    assert r_cfg.__dict__ == p_cfg.__dict__
    j = {k: jnp.asarray(v) for k, v in params.items()}
    r_state = RA.AdamWState(step=jnp.int32(step),
                            mu={k: jnp.asarray(v) for k, v in mu.items()},
                            nu={k: jnp.asarray(v) for k, v in nu.items()})
    r_params, r_new = jax.jit(RA.apply_updates, static_argnums=3)(
        j, {k: jnp.asarray(v) for k, v in grads.items()}, r_state, r_cfg)
    p_state = PA.state_from_arrays(step, mu, nu, "cpu")
    p_params, p_new = PA.apply_updates(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in grads.items()}, p_state, p_cfg)
    assert int(p_new.step) == int(r_new.step) == step + 1
    assert p_new.step.dtype == torch.int32
    for got, want in ((p_params, r_params), (p_new.mu, r_new.mu),
                      (p_new.nu, r_new.nu)):
        for k in shapes:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    np.testing.assert_allclose(
        float(PA.global_norm(g)),
        float(RA.global_norm({k: jnp.asarray(v) for k, v in grads.items()})),
        rtol=1e-6)


def test_schedule_matches_reference():
    for cfg in (dict(lr=1e-2), dict(lr=2e-3, warmup_steps=10),
                dict(lr=2e-3, total_steps=100),
                dict(lr=5e-3, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.2)):
        steps = np.arange(0, 130, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: RA.schedule(
            RA.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
        got = PA.schedule(PA.AdamWConfig(**cfg), torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 16), (10, 2), (11, 7), (40, 5)])
def test_balance_zero_counts_exact(dtype, shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    w2 = _latents(rng, shape).astype(dtype)
    if dtype == np.float64:     # above 1/3 in float64, float32(1/3) in f32
        w2.reshape(-1)[-3:] = [(1 / 3 + F32_THIRD) / 2, -(1 / 3 + F32_THIRD)
                               / 2, F32_THIRD]
    want = RT.balance_zero_counts(w2, RTe.TERNARY_THRESHOLD)
    got = PT.balance_zero_counts(w2, PTe.TERNARY_THRESHOLD)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    nnz = (got != 0).sum(axis=0)
    assert (nnz == nnz[0]).all()


def _train(name):
    return PT.train_tnn(PD.make_dataset(name), PT.TNNTrainConfig(
        n_hidden=PD.DATASETS[name].topology[1], epochs=12, lr=1e-2, seed=0),
        device="cpu")


@pytest.mark.parametrize("name", ["arrhythmia", "redwine", "whitewine"])
def test_train_tnn_codes_equal_golden(name):
    got = _train(name)
    gold = PT.load_tnn(EMIT_DIR / f"{name}_tnn.npz")
    np.testing.assert_array_equal(got.w1t, gold.w1t)
    np.testing.assert_array_equal(got.w2t, gold.w2t)
    np.testing.assert_array_equal(got.thresholds, gold.thresholds)
    assert (got.train_acc, got.test_acc) == (gold.train_acc, gold.test_acc)
    assert got.name == name and got.w1t.dtype == np.int8


@pytest.mark.parametrize("name", ["breast_cancer", "cardio"])
def test_train_tnn_within_accuracy_of_golden(name):
    # the trajectory parts from the reference's (module docstring)
    got = _train(name)
    gold = PT.load_tnn(EMIT_DIR / f"{name}_tnn.npz")
    assert got.topology == gold.topology
    assert got.out_nnz >= 1                     # balanced output zeros
    assert abs(got.test_acc - gold.test_acc) <= 0.05
    xb = PTe.abc_binarize(PD.make_dataset(name).x_test, got.thresholds,
                          device="cpu").numpy()
    ref = RT.TrainedTNN(got.w1t, got.w2t, got.thresholds, 0.0, 0.0)
    assert float((RT.predict_exact(ref, xb) == PD.make_dataset(
        name).y_test).mean()) == got.test_acc


def test_search_tnn_tie_break(monkeypatch):
    """Best test accuracy wins; a tie goes to fewer hidden neurons, and
    among equals to the first trained."""
    acc = {(4, 1e-2, 0): 0.8, (4, 1e-2, 1): 0.9, (2, 1e-2, 0): 0.9,
           (2, 1e-2, 1): 0.85, (8, 1e-2, 0): 0.9, (8, 1e-2, 1): 0.7}
    calls = []

    def fake(ds, cfg, device=None):
        calls.append((cfg.n_hidden, cfg.lr, cfg.seed, cfg.epochs, device))
        t = PT.TrainedTNN(np.zeros((3, cfg.n_hidden), np.int8),
                          np.zeros((cfg.n_hidden, 2), np.int8),
                          np.zeros(3, np.float32), 0.0,
                          acc[(cfg.n_hidden, cfg.lr, cfg.seed)])
        t.name = f"{cfg.n_hidden}/{cfg.seed}"
        return t

    monkeypatch.setattr(PT, "train_tnn", fake)
    best = PT.search_tnn(None, [4, 2, 8], lr_options=[1e-2], epochs=3,
                         device="cpu")
    assert best.name == "2/0"
    assert calls == [(h, 1e-2, s, 3, "cpu") for h in (4, 2, 8)
                     for s in (0, 1)]
    monkeypatch.setattr(PT, "train_tnn", lambda ds, cfg, device=None: fake(
        ds, cfg, device) if cfg.n_hidden != 2 else PT.TrainedTNN(
        np.zeros((3, 2), np.int8), np.zeros((2, 2), np.int8),
        np.zeros(3, np.float32), 0.0, 0.5, "low"))
    assert PT.search_tnn(None, [4, 2, 8], lr_options=[1e-2]).name == "4/1"
