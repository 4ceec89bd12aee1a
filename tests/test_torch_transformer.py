"""The port's dense transformer held against `repro.models.transformer`.

Reduced llama3.2-1b (2 layers, d_model 64, float32) with quant in
{dense, ternary, ternary_packed}.  One numpy parameter tree feeds both: the
reference takes it as jnp arrays, the port through
`params_from_reference`; packed codes are random bytes (all four codes,
0b11 included), not the reference's all-zero init.

Tolerance: `atol = 1e-4` on hidden states, cache and logits.  Both run in
float32 on the CPU with the same formulas; what differs is the order of
float sums (XLA's dot and reduction order against PyTorch's), which moves
results by ~1e-6 at these widths, so 1e-4 leaves margin without hiding a
wrong formula (those move values by O(0.1)).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ATOL = 1e-4
QUANTS = ["dense", "ternary", "ternary_packed"]


def reduced(quant: str):
    return get_config("llama3.2-1b").reduced().replace(quant=quant)


def numpy_tree(cfg, seed: int = 0) -> dict:
    """A random parameter tree in the reference's layout, as numpy."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, d in P.leaves(P.param_defs(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] == "w2":
            a = rng.integers(-128, 128, d.shape).astype(np.int8)
        elif d.dtype == torch.float32 and path[-1] == "scale" and \
                "w2" in node:
            a = np.abs(rng.normal(0.05, 0.01, d.shape)).astype(np.float32)
        elif d.init == "normal":
            a = rng.normal(0, d.init_scale or 0.02, d.shape)
        else:
            a = 1.0 + 0.1 * rng.normal(0, 1, d.shape)
        out_dt = np.int8 if path[-1] == "w2" else np.float32
        node[path[-1]] = np.asarray(a, out_dt)
    return out


def ref_params(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_param_tree_matches_reference(quant):
    cfg = reduced(quant)
    rcfg = ref_get_config("llama3.2-1b").reduced().replace(quant=quant)
    ref = RP.init_params(jax.random.PRNGKey(0), rcfg)
    port = P.init_params(cfg, seed=0, device="cpu")
    rleaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    pleaves = list(P.leaves(port))
    assert [tuple(k.key for k in path) for path, _ in rleaves] == \
        [path for path, _ in pleaves]
    for (_, r), (_, t) in zip(rleaves, pleaves):
        assert tuple(r.shape) == tuple(t.shape)
        assert str(r.dtype) == str(t.dtype).removeprefix("torch.")
    if quant == "ternary_packed":   # the reference's init: all-zero codes
        assert not port["layers"]["mlp"]["w_up"]["w2"].any()
    assert P.param_count(cfg) == RP.param_count(rcfg)
    full = get_config("llama3.2-1b").replace(quant=quant)
    rfull = ref_get_config("llama3.2-1b").replace(quant=quant)
    assert P.param_count(full) == RP.param_count(rfull)
    assert [tuple(d.shape) for _, d in P.leaves(P.param_defs(full))] == \
        [tuple(d.shape) for d in jax.tree.leaves(
            RP.param_defs(rfull), is_leaf=RP.is_def)]


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_prefill_decode_match_reference(quant):
    cfg = reduced(quant)
    tree = numpy_tree(cfg, seed=1)
    rp, tp = ref_params(tree), P.params_from_reference(tree, device="cpu")
    rng = np.random.default_rng(2)
    B, S, cache_len = 2, 6, 16
    tokens = rng.integers(0, cfg.vocab, (B, S))

    with torch.inference_mode():
        h, _ = TF.forward(cfg, tp, {"tokens": torch.from_numpy(tokens)})
    rh, _, _ = RTF.forward(cfg, rp, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)})
    _close(h, rh)

    with torch.inference_mode():
        h, cache = TF.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens)},
                              cache_len)
    rh, rcache = RTF.prefill(cfg, rp, {"tokens": jnp.asarray(tokens,
                                                              jnp.int32)},
                             cache_len)
    _close(h, rh)
    for name in ("k", "v"):
        assert cache[name].shape == rcache[name].shape
        _close(cache[name], rcache[name])

    logits = RTF.logits_from_hidden(cfg, rp, rh[:, -1:])
    for step in range(3):
        tok = np.array(jnp.argmax(logits, axis=-1))         # (B, 1)
        with torch.inference_mode():
            got, cache = TF.decode_step(cfg, tp, cache, torch.from_numpy(tok),
                                        S + step)
        logits, rcache = RTF.decode_step(cfg, rp, rcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.int32(S + step))
        assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got, logits)
    _close(cache["k"], rcache["k"])


def test_decode_outside_cache_raises():
    cfg = reduced("dense")
    tp = P.params_from_reference(numpy_tree(cfg), device="cpu")
    cache = TF.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        TF.decode_step(cfg, tp, cache, torch.zeros((1, 1), dtype=torch.long),
                       4)


def test_params_from_reference_carries_bf16_bits():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (5, 7)).astype(ml_dtypes.bfloat16)
    b = np.asarray(jnp.asarray(rng.normal(0, 1, (3,)), jnp.bfloat16))
    tree = {"x": {"w": a}, "y": b, "z": np.arange(4, dtype=np.int8)}
    got = P.params_from_reference(tree, device="cpu")
    assert got["x"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"]["w"].view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(got["y"].view(torch.int16).numpy(),
                                  b.view(np.int16))
    assert got["z"].dtype == torch.int8


def _vlm_short_prompt():
    cfg = get_config("qwen2-vl-72b").reduced()          # 4 vision tokens
    tp = P.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.long),
             "vision_embeds": torch.zeros((1, cfg.n_vision_tokens,
                                           cfg.d_model))}
    TF.forward(cfg, tp, batch)


def _unknown_kv_dtype():
    TF.init_cache(reduced("dense").replace(kv_cache_dtype="int4"), 1, 4,
                  device="cpu")


REFUSED = {
    # the reference's Mamba and RWKV blocks read dense `w` leaves whatever
    # the quant (under "ternary_packed" the reference raises KeyError)
    **{f"{arch}-{quant}": (
        ValueError, "dense only",
        lambda a=arch, q=quant: P.param_defs(
            get_config(a).reduced().replace(quant=q)))
       for arch in ("hymba-1.5b", "rwkv6-7b")
       for quant in ("ternary", "ternary_packed")},
    "vlm-prompt-shorter-than-vision-tokens": (
        ValueError, "shorter than", _vlm_short_prompt),
    "unknown-arch": (KeyError, "unknown arch",
                     lambda: get_config("llama3.2-70b")),
    "unknown-kv-cache-dtype": (ValueError, "kv_cache_dtype",
                               _unknown_kv_dtype),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_other_families_not_ported(case):
    """Every reference arch is ported; what the port still refuses: the
    dense-only blocks under a quantized mode, a VLM prompt shorter than its
    vision embeddings, an unknown arch id and an unknown KV-cache dtype."""
    exc, match, call = REFUSED[case]
    with pytest.raises(exc, match=match):
        call()
