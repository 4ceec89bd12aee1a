"""The port's RWKV-6 mixers held against `repro.models.ssm`.

Reduced rwkv6-7b (d_model 64, 4 heads of 16, lora rank 4, float32).  One
numpy parameter tree feeds both sides; every leaf is random, so the token
shifts (`mu_*`), the bonus `u` and the decay offset `w0` are not the
reference's all-zero init, and the decays `exp(-exp(w0 + ...))` spread
over (0, 1).  The port's recurrence runs through `kernels.ops.rwkv6_scan`
(its plain version on the CPU), the reference's through `lax.scan`.

Tolerance: `atol = 1e-4`, as in `test_torch_transformer.py`: both run the
same float32 formulas and differ in the order of float sums (~1e-6 at
these widths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ssm as RSSM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

ATOL = 1e-4


def reduced():
    return get_config("rwkv6-7b").reduced()


def rwkv_numpy_tree(cfg, seed: int = 0) -> dict:
    """A random RWKV-6 parameter tree in the reference's layout, as
    float32 numpy arrays, every leaf drawn (none left at its init)."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, d in P.leaves(P.param_defs(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        name = path[-1]
        if d.init == "normal":
            a = rng.normal(0, d.init_scale or 0.02, d.shape)
        elif name.startswith("mu_"):
            a = rng.uniform(0, 1, d.shape)
        elif name in ("w0", "u"):
            a = rng.normal(0, 1 if name == "w0" else 0.5, d.shape)
        else:
            a = 1.0 + 0.1 * rng.normal(0, 1, d.shape)
        node[name] = np.asarray(a, np.float32)
    return out


def _layer0(tree: dict) -> dict:
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    H, dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, D), (B, D), (B, H, dh, dh))]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_timemix_matches_reference(with_state, S):
    cfg = reduced()
    tm = _layer0(rwkv_numpy_tree(cfg, seed=S))["layers"]["tm"]
    B = 2
    x = np.random.default_rng(S + 1).normal(0, 1, (B, S, cfg.d_model)) \
        .astype(np.float32)
    st = _state(cfg, B, S + 2) if with_state else None
    port_p = P.params_from_reference(tm, device="cpu")
    with torch.inference_mode():
        out, last, wkv = SSM.rwkv6_timemix(
            port_p, torch.from_numpy(x), cfg.n_heads,
            None if st is None else SSM.RWKVState(
                *(torch.from_numpy(a) for a in st)))
    r_out, r_last, r_wkv = RSSM.rwkv6_timemix(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x), cfg.n_heads,
        None if st is None else RSSM.RWKVState(
            *(jnp.asarray(a) for a in st)))
    assert wkv.dtype == torch.float32
    assert tuple(wkv.shape) == (B, cfg.n_heads, cfg.head_dim, cfg.head_dim)
    _close(out, r_out)
    _close(last, r_last)
    _close(wkv, r_wkv)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_channelmix_matches_reference(with_state, S):
    cfg = reduced()
    cm = _layer0(rwkv_numpy_tree(cfg, seed=10 + S))["layers"]["cm"]
    B = 3
    x = np.random.default_rng(S).normal(0, 1, (B, S, cfg.d_model)) \
        .astype(np.float32)
    st = _state(cfg, B, S + 5) if with_state else None
    with torch.inference_mode():
        out, last = SSM.rwkv6_channelmix(
            P.params_from_reference(cm, device="cpu"), torch.from_numpy(x),
            None if st is None else SSM.RWKVState(
                *(torch.from_numpy(a) for a in st)))
    r_out, r_last = RSSM.rwkv6_channelmix(
        jax.tree.map(jnp.asarray, cm), jnp.asarray(x),
        None if st is None else RSSM.RWKVState(
            *(jnp.asarray(a) for a in st)))
    _close(out, r_out)
    _close(last, r_last)


def test_timemix_sends_its_recurrence_through_ops(monkeypatch):
    """The time-mix's WKV goes to `ops.rwkv6_scan_heads` on the
    projections' own (B, S, H, dh) views in the compute dtype, with no
    head-major copy, u as one (H, dh) bonus for the batch; with
    `wkv_out`, the state is written there (here the given state's own
    tensor, as the decode step does)."""
    from repro_torch.kernels import ops

    cfg = reduced()
    tm = _layer0(rwkv_numpy_tree(cfg, seed=3))["layers"]["tm"]
    seen = []
    real = ops.rwkv6_scan_heads

    def spy(r, k, v, w, u, s0=None, s_out=None):
        seen.append((tuple(r.shape), r.stride(), r.dtype, tuple(u.shape),
                     s0, s_out, float(w.min()), float(w.max())))
        return real(r, k, v, w, u, s0, s_out)

    monkeypatch.setattr(ops, "rwkv6_scan_heads", spy)
    B, S, D = 2, 5, cfg.d_model
    H, dh = cfg.n_heads, cfg.head_dim
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (B, S, D)).astype(np.float32))
    port_p = P.params_from_reference(tm, device="cpu")
    SSM.rwkv6_timemix(port_p, x, cfg.n_heads, None)
    st = SSM.RWKVState(*(torch.from_numpy(a) for a in _state(cfg, B, 4)))
    wkv = st.wkv
    _, _, new = SSM.rwkv6_timemix(port_p, x, cfg.n_heads, st, wkv_out=wkv)
    assert len(seen) == 2
    for (shape, stride, dtype, ushape, s0, s_out, w_min, w_max), state in \
            zip(seen, (None, wkv)):
        assert shape == (B, S, H, dh) and stride == (S * D, D, dh, 1)
        assert dtype == x.dtype and ushape == (H, dh)
        assert s0 is state and s_out is state
        assert 0 < w_min < w_max < 1
    assert new is wkv
