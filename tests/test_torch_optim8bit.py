"""The port's 8-bit AdamW and int8 gradient compression against the
reference's, on the CPU.

* `_quantize` / `_dequantize`: codes, scales and dequantized values
  bit-equal to `repro.optim.adamw8bit`'s on the same float32 arrays
  (every quotient divides by a tensor, as XLA divides).
* Several steps from the same parameters and gradients: parameters within
  `STEP_TOL = 1e-6` (measured 2.4e-7: the update's f32 ops in another
  order), moments' codes equal.
* The one departure (`optim/adamw8bit.py`'s docstring):
  where a stored second-moment code is 0 and the next gradient is 0 too,
  the reference divides m_hat by eps alone; the port floors v at b2 times
  half the block's step.  Held on the smallest such input, and shown to
  leave every entry with a non-zero code alone.
* `grad_compress`: equal to the reference (quantized codes exactly, the
  dequantized gradients and error buffers bit-equal), and error feedback
  keeps the cumulative sum within one quantum of the true one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as RA  # noqa: E402
from repro.optim import adamw8bit as R8  # noqa: E402
from repro.optim import grad_compress as RG  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import adamw8bit as P8  # noqa: E402
from repro_torch.optim import grad_compress as PG  # noqa: E402

STEP_TOL = 1e-6


def _toy():
    params = {"a": np.asarray([1.0, -2.0, 3.0], np.float32),
              "b": {"w": np.ones((4, 4), np.float32)}}
    grads = {"a": np.asarray([0.1, 0.2, -0.3], np.float32),
             "b": {"w": np.full((4, 4), 0.05, np.float32)}}
    return params, grads


def _t(tree):
    return PA.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("shape", [(3,), (4, 4), (1100,), (2, 3, 1030),
                                   (513,), (1,), (2, 512)])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e3])
def test_quantize_bit_equal_to_reference(shape, scale):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    rq = R8._quantize(jnp.asarray(x))
    pq = P8._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.codes.numpy(), np.asarray(rq.codes))
    np.testing.assert_array_equal(pq.scales.numpy(), np.asarray(rq.scales))
    assert pq.codes.dtype == torch.int8
    np.testing.assert_array_equal(P8._dequantize(pq).numpy(),
                                  np.asarray(R8._dequantize(rq)))


def _run_steps(n=5):
    """n steps of both 8-bit AdamWs from the same random parameters and
    gradients; returns the reference's and the port's params and states
    and, per port leaf, where a stored second-moment code was 0 before
    some step after the first (where the port's floor may act)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3,)).astype(np.float32),
              "b": {"w": rng.normal(size=(4, 600)).astype(np.float32)},
              "s": np.float32(0.5)}
    cfg = dict(lr=0.01, weight_decay=0.1, warmup_steps=2, total_steps=10)
    rp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    rs, ts = R8.init(rp), P8.init(tp)
    zero = [torch.zeros(q.codes.shape, dtype=torch.bool)
            for q in PA.tree_leaves(ts.nu)]
    for i in range(n):
        if i:
            zero = [z | (q.codes == 0) for z, q in
                    zip(zero, PA.tree_leaves(ts.nu))]
        g = {"a": rng.normal(size=(3,)).astype(np.float32),
             "b": {"w": rng.normal(size=(4, 600)).astype(np.float32)},
             "s": np.float32(rng.normal())}
        rp, rs = R8.apply_updates(rp, jax.tree.map(jnp.asarray, g), rs,
                                  RA.AdamWConfig(**cfg))
        tp, ts = P8.apply_updates(tp, _t(g), ts, PA.AdamWConfig(**cfg))
    return rp, rs, tp, ts, zero


def test_several_steps_match_reference(monkeypatch):
    """Without the floor (`_half_step` zero) the port's steps are the
    reference's: parameters within STEP_TOL, moments' codes equal but for
    round-half ties."""
    monkeypatch.setattr(P8, "_half_step", lambda q: torch.zeros(
        q.codes.shape, dtype=torch.float32))
    rp, rs, tp, ts, _ = _run_steps()
    for a, b in zip(jax.tree.leaves(rp), PA.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=STEP_TOL)
    rq = jax.tree.leaves(rs.mu, is_leaf=lambda t: isinstance(t, R8.Q8Tensor))
    pq = PA.tree_leaves(ts.mu)
    assert int(ts.step) == int(rs.step) == 5
    for a, b in zip(rq, pq):
        assert b.scales.shape == a.scales.shape
        assert int((b.codes.numpy() != np.asarray(a.codes)).sum()) <= 1


def test_floor_acts_only_where_a_code_was_zero():
    """With the floor, the steps differ from the reference's only in
    entries whose stored second-moment code was 0 before a step."""
    rp, _, tp, _, zero = _run_steps()
    for a, b, z in zip(jax.tree.leaves(rp), PA.tree_leaves(tp), zero):
        far = np.abs(b.numpy() - np.asarray(a)) > STEP_TOL
        assert not (far & ~z.reshape(far.shape).numpy()).any()


def test_parity_multi_step_with_adamw():
    """The counterpart of `test_optim.py::test_adamw8bit_parity_multi_step`:
    five steps of 8-bit AdamW within int8 quantization error of f32."""
    params, grads = _toy()
    cfg = PA.AdamWConfig(lr=0.01)
    p1, s1 = _t(params), PA.init(_t(params))
    p2, s2 = _t(params), P8.init(_t(params))
    for _ in range(5):
        p1, s1 = PA.apply_updates(p1, _t(grads), s1, cfg)
        p2, s2 = P8.apply_updates(p2, _t(grads), s2, cfg)
    d = max(float((x - y).abs().max()) for x, y in
            zip(PA.tree_leaves(p1), PA.tree_leaves(p2)))
    assert d < 5e-3


def test_memory_layout():
    params, _ = _toy()
    params["s"] = np.float32(2.0)                       # a 0-d leaf
    st = P8.init(_t(params))
    for q, p in zip(PA.tree_leaves(st.mu), PA.tree_leaves(_t(params))):
        assert isinstance(q, P8.Q8Tensor)
        assert tuple(q.codes.shape) == (tuple(p.shape) or (1,))
        assert q.codes.dtype == torch.int8 and q.scales.dtype == torch.float32
        assert q.scales.shape[-1] == -(-q.codes.shape[-1] // P8.BLOCK)
    assert st.step.dtype == torch.int32 and st.step.dim() == 0


def _departure_case():
    """The smallest input of the reference's fault: two entries, the
    second gradient 1/50 of the first, then zero (as int8 compression
    rounds it)."""
    params = {"w": np.zeros(2, np.float32)}
    grads = [{"w": np.asarray([1.0, 0.02], np.float32)},
             {"w": np.asarray([1.0, 0.0], np.float32)}]
    return params, grads


def test_zero_second_moment_code_departure():
    params, grads = _departure_case()
    cfg = dict(lr=1e-3, grad_clip=None)
    rp, rs = jax.tree.map(jnp.asarray, params), None
    rs = R8.init(rp)
    tp, ts = _t(params), P8.init(_t(params))
    for g in grads:
        rp, rs = R8.apply_updates(rp, jax.tree.map(jnp.asarray, g), rs,
                                  RA.AdamWConfig(**cfg))
        tp, ts = P8.apply_updates(tp, _t(g), ts, PA.AdamWConfig(**cfg))
    ref_w, port_w = np.asarray(rp["w"]), tp["w"].numpy()
    # entry 0 (codes non-zero): the same update; entry 1: the reference
    # divides its first moment by eps and jumps by ~1e3
    assert abs(ref_w[0] - port_w[0]) <= 1e-7
    assert abs(ref_w[1]) > 100.0
    assert abs(port_w[1]) < 1e-2
    # the stored moments are the reference's
    for a, b in ((rs.mu["w"], ts.mu["w"]), (rs.nu["w"], ts.nu["w"])):
        np.testing.assert_array_equal(b.codes.numpy(), np.asarray(a.codes))
        np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a.scales))


def test_floor_leaves_nonzero_codes_alone():
    """Over random steps where no stored v code is 0, the floor changes
    nothing: the parameters equal those of the unfloored update."""
    rng = np.random.default_rng(1)
    p = _t({"w": rng.normal(size=(2, 512)).astype(np.float32)})
    st = P8.init(p)
    cfg = PA.AdamWConfig(lr=1e-2, grad_clip=None)
    for _ in range(3):
        g = _t({"w": rng.uniform(0.5, 1.0, (2, 512)).astype(np.float32)})
        half = P8._half_step(st.nu["w"])
        vq = st.nu["w"]
        new, st2 = P8.apply_updates(p, g, st, cfg)
        if bool((vq.codes != 0).all()):
            v = cfg.b2 * P8._dequantize(vq) + (1 - cfg.b2) * g["w"] ** 2
            assert bool((v >= cfg.b2 * half).all())
        p, st = new, st2
    assert int(st.step) == 3


def test_grad_compress_matches_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
         "b": {"w": (rng.normal(0, 1e-3, (33,))).astype(np.float32)}}
    rerr = RG.init_error_buffer(jax.tree.map(jnp.asarray, g))
    perr = PG.init_error_buffer(_t(g))
    for _ in range(3):
        rdeq, rerr = RG.compress_grads(jax.tree.map(jnp.asarray, g), rerr)
        pdeq, perr = PG.compress_grads(_t(g), perr)
        for a, b in zip(jax.tree.leaves((rdeq, rerr)),
                        PA.tree_leaves({"d": pdeq, "e": perr})):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    q, s = PG._q8(torch.from_numpy(g["a"]))
    rq, rs = RG._q8(jnp.asarray(g["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


@pytest.mark.parametrize("seed", range(8))
def test_grad_compress_error_feedback_unbiased(seed):
    """The counterpart of `test_optim.py::
    test_grad_compress_error_feedback_unbiased`: over repeated identical
    gradients the cumulative dequantized sum stays within one quantum of
    the true sum."""
    r = np.random.default_rng(seed)
    g = {"w": torch.from_numpy(r.normal(0, 1, (32,)).astype(np.float32))}
    err = PG.init_error_buffer(g)
    total = torch.zeros(32)
    n = 8
    for _ in range(n):
        deq, err = PG.compress_grads(g, err)
        total = total + deq["w"]
    drift = float((total - n * g["w"]).abs().max())
    assert drift <= float(g["w"].abs().max()) / 127.0 * 1.5 + 1e-6


def test_state_from_arrays_takes_the_reference_state():
    params, grads = _toy()
    rp = jax.tree.map(jnp.asarray, params)
    rs = R8.init(rp)
    rp, rs = R8.apply_updates(rp, jax.tree.map(jnp.asarray, grads), rs,
                              RA.AdamWConfig(lr=0.01))
    st = P8.state_from_arrays(
        np.array(rs.step), jax.tree.map(np.asarray, rs.mu),
        jax.tree.map(np.asarray, rs.nu), "cpu")
    assert isinstance(st.mu["a"], P8.Q8Tensor) and int(st.step) == 1
    np.testing.assert_array_equal(st.nu["b"]["w"].codes.numpy(),
                                  np.asarray(rs.nu["b"]["w"].codes))
    rp2, _ = R8.apply_updates(rp, jax.tree.map(jnp.asarray, grads), rs,
                              RA.AdamWConfig(lr=0.01))
    tp2, _ = P8.apply_updates(_t(jax.tree.map(np.asarray, rp)), _t(grads),
                              st, PA.AdamWConfig(lr=0.01))
    for a, b in zip(jax.tree.leaves(rp2), PA.tree_leaves(tp2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=STEP_TOL)
