"""The port's model layers held against `repro.models` in float32.

Same numpy inputs through the reference and the port (`device="cpu"`),
compared at rtol = atol = 1e-5: both compute in f32 with the same
formulas, so only the order of float sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as RATT  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.core.ternary import pack_ternary  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(0, scale, shape)).astype(np.float32)


def test_rms_and_layer_norm():
    rng = np.random.default_rng(0)
    x, s, b = _normal(rng, 2, 5, 64), _normal(rng, 64), _normal(rng, 64)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    _close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b)),
           RL.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


def test_rope():
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 7, 4, 16)
    pos = np.arange(3, 10)[None, :]
    cos, sin = L.rope_cos_sin(torch.from_numpy(pos), 16, 5e5)
    rcos, rsin = RL.rope_cos_sin(jnp.asarray(pos), 16, 5e5)
    _close(cos, rcos)
    _close(sin, rsin)
    _close(L.apply_rope(torch.from_numpy(x), cos, sin),
           RL.apply_rope(jnp.asarray(x), rcos, rsin))


@pytest.mark.parametrize("quant", ["dense", "ternary", "ternary_packed"])
def test_linear_modes(quant):
    rng = np.random.default_rng(2)
    x, b = _normal(rng, 3, 5, 32), _normal(rng, 24)
    w = _normal(rng, 32, 24)
    if quant == "ternary_packed":
        codes = rng.integers(-1, 2, (32, 24)).astype(np.float32)
        p = {"w2": pack_ternary(torch.from_numpy(codes)).numpy(),
             "scale": np.abs(_normal(rng, 1, 24)), "b": b}
    else:
        p = {"w": w, "b": b}
    got = L.linear({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x), quant)
    _close(got, RL.linear({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), quant))


@pytest.mark.parametrize("S,block_k,window,q_offset", [
    (13, 4, None, 0),        # several blocks, ragged last one
    (16, 8, 5, 0),           # sliding window
    (6, 4, None, 5),         # a chunk whose queries start at position 5
])
def test_blockwise_attention_gqa(S, block_k, window, q_offset):
    rng = np.random.default_rng(S + block_k)
    B, H, K, dh = 2, 4, 2, 16
    Sk = S + q_offset
    q, k, v = (_normal(rng, B, S, H, dh), _normal(rng, B, Sk, K, dh),
               _normal(rng, B, Sk, K, dh))
    got = ATT.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=q_offset, block_k=block_k)
    want = RATT.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset, block_k=block_k)
    _close(got, want)


def test_decode_attention_linear_mask():
    rng = np.random.default_rng(3)
    B, H, K, dh, Sc, pos = 2, 4, 2, 16, 12, 6
    q = _normal(rng, B, 1, H, dh)
    kc, vc = _normal(rng, B, Sc, K, dh), _normal(rng, B, Sc, K, dh)
    mask = ATT.linear_mask(pos, Sc)
    rmask = RATT.linear_mask(jnp.int32(pos), Sc)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    _close(ATT.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), mask),
           RATT.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), rmask))


@pytest.mark.parametrize("pos", [0, 3, 8, 21])
def test_rolling_cache_helpers(pos):
    Sc = 8
    np.testing.assert_array_equal(
        ATT.rolling_mask(pos, Sc).numpy(),
        np.asarray(RATT.rolling_mask(jnp.int32(pos), Sc)))
    assert ATT.rolling_slot(pos, Sc) == int(RATT.rolling_slot(
        jnp.int32(pos), Sc))
