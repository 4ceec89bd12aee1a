"""The port's Mamba mixer and hymba-1.5b held against `repro.models.ssm`
and `repro.models.transformer`.

* `mamba_forward` from no state: output and state (the last `h`, the last
  `W - 1` pre-conv inputs) within `ATOL` (1e-4) of the reference's; the
  port loops over the sequence where the reference runs an associative
  scan, so only the rounding order differs.
* A decode step from the prefill's state, against the reference's
  `mamba_decode` from its own.
* A carried-in state enters step 0 as the reference adds it (a random `h`
  with a zero conv window: both agree).
* The port's prefill split in two with the state carried across equals one
  pass within 1e-6 (only the projections' float sums see other shapes).
  The reference's `mamba_forward` zero-pads the causal conv whatever state
  it is given, so its split run differs at the seam; the model never
  calls it with a state, and the port reads the state's conv window.
* hymba-1.5b (reduced, dense; attention and Mamba in parallel, sliding
  window 8, so the decode cache rolls) through
  `torch_lm_reference.check_model`.
* hymba with a quantized mode raises `ValueError` in the port.  (The
  reference's Mamba reads `p["in_proj"]["w"]` whatever the quant, so it
  raises `KeyError` under "ternary_packed" and serves dense products under
  "ternary"; not asserted here.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ssm as RS  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import ATOL, cfgs, check_model, numpy_tree  # noqa: E402,E501


def _mamba(seed: int = 0):
    """Layer 0's Mamba leaves of reduced hymba (numpy, random) and an
    input (B, S, D)."""
    cfg, _ = cfgs("hymba-1.5b", "dense")
    tree = numpy_tree(cfg, seed=seed)
    p = jax.tree.map(lambda a: a[0], tree["layers"]["mamba"])
    x = np.random.default_rng(seed + 1).normal(
        0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_mamba_forward_matches_reference():
    _, p, x = _mamba()
    out, st = S.mamba_forward(_t(p), torch.from_numpy(x))
    rout, rst = RS.mamba_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(out, rout)
    _close(st.h, rst.h)
    _close(st.conv, rst.conv)
    assert st.conv.shape == (2, 3, p["conv_w"].shape[1])


def test_mamba_decode_from_prefill_state_matches_reference():
    _, p, x = _mamba(seed=2)
    _, st = S.mamba_forward(_t(p), torch.from_numpy(x[:, :-1]))
    _, rst = RS.mamba_forward(jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x[:, :-1]))
    out, st = S.mamba_decode(_t(p), torch.from_numpy(x[:, -1:]), st)
    rout, rst = RS.mamba_decode(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x[:, -1:]), rst)
    _close(out, rout)
    _close(st.h, rst.h)
    _close(st.conv, rst.conv)


def test_carried_state_enters_step_zero_as_the_reference_adds_it():
    _, p, x = _mamba(seed=3)
    rng = np.random.default_rng(4)
    h0 = rng.normal(0, 1, (x.shape[0],) + p["A_log"].shape).astype(np.float32)
    conv0 = np.zeros((x.shape[0], 3, p["conv_w"].shape[1]), np.float32)
    out, st = S.mamba_forward(_t(p), torch.from_numpy(x),
                              S.MambaState(torch.from_numpy(h0),
                                           torch.from_numpy(conv0)))
    rout, rst = RS.mamba_forward(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x),
                                 RS.MambaState(jnp.asarray(h0),
                                               jnp.asarray(conv0)))
    _close(out, rout)
    _close(st.h, rst.h)


@pytest.mark.parametrize("cut", [1, 3, 5])
def test_prefill_split_in_two_equals_one_pass(cut):
    _, p, x = _mamba(seed=5)
    pt, xt = _t(p), torch.from_numpy(x)
    whole, st_whole = S.mamba_forward(pt, xt)
    first, st = S.mamba_forward(pt, xt[:, :cut])
    second, st = S.mamba_forward(pt, xt[:, cut:], st)
    _close(torch.cat([first, second], dim=1), whole, atol=1e-6)
    _close(st.h, st_whole.h, atol=1e-6)
    _close(st.conv, st_whole.conv, atol=1e-6)


def test_decode_steps_continue_the_prefill():
    """Prefill of x[:, :5] then four decode steps equals one pass over x."""
    _, p, x = _mamba(seed=6)
    pt, xt = _t(p), torch.from_numpy(x)
    whole, _ = S.mamba_forward(pt, xt)
    outs, st = [], None
    out, st = S.mamba_forward(pt, xt[:, :5])
    outs.append(out)
    for t in range(5, x.shape[1]):
        out, st = S.mamba_decode(pt, xt[:, t:t + 1], st)
        outs.append(out)
    _close(torch.cat(outs, dim=1), whole, atol=1e-6)


def test_hymba_model_matches_reference():
    cache = check_model("hymba-1.5b", "dense", steps=4)
    assert cache["mamba_h"].dtype == torch.float32
    assert cache["mamba_conv"].shape[2] == 3


def test_hymba_decode_updates_the_cache_in_place():
    cfg, _ = cfgs("hymba-1.5b", "dense")
    tp = P.params_from_reference(numpy_tree(cfg, seed=7), device="cpu")
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, tp, {"tokens": torch.ones(
            (2, 8), dtype=torch.long)}, 16)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        before = cache["mamba_h"].clone()
        _, out = TF.decode_step(cfg, tp, cache, torch.ones(
            (2, 1), dtype=torch.long), 8)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert not torch.equal(cache["mamba_h"], before)


@pytest.mark.parametrize("quant", ["ternary", "ternary_packed"])
def test_quantized_hymba_is_refused(quant):
    cfg, _ = cfgs("hymba-1.5b", quant)
    for build in (P.param_defs, lambda c: P.init_params(c, device="cpu"),
                  lambda c: P.serving_params(c, device="cpu")):
        with pytest.raises(ValueError, match="dense only"):
            build(cfg)
    with pytest.raises(ValueError, match="dense only"):
        TF.init_cache(cfg, 1, 8, device="cpu")
