"""The port's MoE FFN held against `repro.models.moe`, alone and in the
mixtral-8x22b and arctic-480b models.

* `capacity` equal to the reference's.
* Routing: the experts each token picks (`tope`), whether each assignment
  keeps a slot (`keep`) and the slot it lands in (`dst`) equal the
  reference's exactly; the router probabilities and renormalized weights
  within 1e-6.  The reference's routing steps (`repro/models/moe.py`, the
  lines from the router einsum to `dst`) are restated below in JAX, since
  `moe_ffn` returns none of them.
* `moe_ffn`'s output within `ATOL` (1e-4) and its aux loss within 1e-6,
  with one group and with two, and in a case where a router scaled toward
  expert 0 overloads it, so assignments are dropped (`keep` has `False`
  entries).
* The reduced models' forward, prefill and decode through
  `torch_lm_reference.check_model`, dense and ternary_packed (experts stay
  dense in every mode, as in the reference).

All float32 on the CPU; tolerances as `tests/test_torch_transformer.py`
states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as RM  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

from torch_lm_reference import ATOL, cfgs, check_model  # noqa: E402

# (T tokens as B x S, E, k, D, groups, overload expert 0)
CASES = {
    "mixtral-like": ((2, 16), 8, 2, 32, None, False),
    "arctic-like": ((4, 8), 16, 2, 32, None, False),
    "two-groups": ((2, 12), 4, 2, 16, 2, False),
    "top-1": ((3, 5), 4, 1, 16, None, False),
    "dropping": ((2, 16), 4, 2, 16, None, True),
}


def _inputs(case: str, seed: int = 0):
    (B, S), E, k, D, G, overload = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    w = rng.normal(0, 0.3, (D, E)).astype(np.float32)
    if overload:      # every token's first choice: expert 0
        x += 1.0
        w[:, 0] = 0.5
    F = 24
    p = {"router": {"w": w},
         "experts": {"w_gate": rng.normal(0, D ** -0.5, (E, D, F)),
                     "w_up": rng.normal(0, D ** -0.5, (E, D, F)),
                     "w_down": rng.normal(0, F ** -0.5, (E, F, D))}}
    p["experts"] = {n: a.astype(np.float32) for n, a in p["experts"].items()}
    return x, p, E, k, G


def _ref_routing(x, w, E, k, G):
    """The reference's routing steps (`repro/models/moe.py`), in JAX."""
    B, S, D = x.shape
    T = B * S
    if G is None or T % G:
        G = 1
    Tg = T // G
    C = RM.capacity(Tg, E, k, 1.25)
    xg = jnp.asarray(x).reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xg, jnp.asarray(w))
    probs = jax.nn.softmax(logits, axis=-1)
    topw, tope = jax.lax.top_k(probs, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    fe = tope.reshape(G, Tg * k)
    onehot = jax.nn.one_hot(fe, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - onehot
    seg_pos = jnp.take_along_axis(pos_all, fe[..., None], -1)[..., 0]
    keep = seg_pos < C
    dst = jnp.where(keep, fe * C + seg_pos, E * C)
    return C, G, [np.asarray(a) for a in (probs, topw, tope, keep, dst)]


def _port(a):
    return {k: _port(v) for k, v in a.items()} if isinstance(a, dict) \
        else torch.from_numpy(a)


@pytest.mark.parametrize("args", [(8, 8, 2, 1.25), (256, 8, 2, 1.25),
                                  (256, 128, 2, 1.25), (1, 4, 1, 1.0),
                                  (12000, 16, 2, 2.0)])
def test_capacity_matches_reference(args):
    assert M.capacity(*args) == RM.capacity(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_matches_reference(case):
    x, p, E, k, G = _inputs(case)
    C, G, (probs, topw, tope, keep, dst) = _ref_routing(x, p["router"]["w"],
                                                        E, k, G)
    xg = torch.from_numpy(x).reshape(G, -1, x.shape[-1])
    r = M.route(torch.from_numpy(p["router"]["w"]), xg, E, k, C)
    np.testing.assert_array_equal(r.tope.numpy(), tope)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.dst.numpy(), dst)
    np.testing.assert_allclose(r.probs.numpy(), probs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r.topw.numpy(), topw, rtol=0, atol=1e-6)
    if case == "dropping":
        assert not keep.all()       # expert 0 is over capacity


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    x, p, E, k, G = _inputs(case, seed=1)
    y, aux = M.moe_ffn(_port(p), torch.from_numpy(x), n_experts=E, top_k=k,
                       capacity_factor=1.25, n_groups=G)
    ry, raux = RM.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          n_experts=E, top_k=k, capacity_factor=1.25,
                          quant="dense", ctx=None, ep=False, n_groups=G)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=1e-6)


def test_dropped_assignments_contribute_nothing():
    """With expert 0 over capacity, a token whose every choice was dropped
    gets a zero output."""
    x, p, E, k, _ = _inputs("dropping", seed=2)
    p["experts"]["w_gate"][1:] = 0.0        # only expert 0 computes
    y, _ = M.moe_ffn(_port(p), torch.from_numpy(x), n_experts=E, top_k=k,
                     capacity_factor=1.25)
    xg = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    r = M.route(torch.from_numpy(p["router"]["w"]), xg, E, k,
                M.capacity(xg.shape[1], E, k, 1.25))
    first = r.keep.reshape(-1, k)[:, 0]        # the expert-0 assignment
    assert (~first).any()
    y = y.reshape(-1, x.shape[-1])
    assert torch.all(y[~first] == 0) and torch.all(y[first].abs().sum(-1) > 0)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_moe_model_matches_reference(arch, quant):
    check_model(arch, quant)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_experts_stay_dense_when_packed(arch):
    cfg, _ = cfgs(arch, "ternary_packed")
    tp = P.serving_params(cfg, seed=0, device="cpu")
    moe = tp["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert set(moe["experts"]) == {"w_gate", "w_up", "w_down"}
    assert "w2" in tp["layers"]["attn"]["wq"]
    if cfg.moe.dense_residual:      # arctic's residual MLP is a projection
        assert "w2" in tp["layers"]["mlp"]["w_up"]
        assert tp["layers"]["mlp"]["w_down"]["w2"].shape[1:] == \
            (cfg.moe.d_ff_dense // 4, cfg.d_model)
