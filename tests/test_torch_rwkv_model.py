"""The port's RWKV-6 model and serving held against the reference.

Reduced rwkv6-7b (2 layers, d_model 64, 4 heads of 16, float32): forward,
prefill (with its shift and WKV cache) and four greedy decode steps
against `repro.models.transformer`, and `ServingEngine` tokens against
`repro.serve.lm_engine`, on one random numpy tree carried across by
`params_from_reference` (`test_torch_ssm.rwkv_numpy_tree`).  The full-size
tree is held to the reference's `param_defs` leaf by leaf.

Tolerance: `atol = 1e-4` on hidden states, cache and logits, as in
`test_torch_transformer.py`.  Greedy tokens are compared exactly, with
every step's top-2 margin asserted above the logits tolerance, so a
near-tie cannot decide the test.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro.serve import lm_engine as RE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serve import lm_engine as E  # noqa: E402

from test_torch_ssm import reduced, rwkv_numpy_tree  # noqa: E402

ATOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_forward_prefill_decode_match_reference():
    cfg = reduced()
    tree = rwkv_numpy_tree(cfg, seed=1)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = P.params_from_reference(tree, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 7))

    with torch.inference_mode():
        h, _, caches = TF.forward(cfg, tp,
                                  {"tokens": torch.from_numpy(tokens)})
    rh, _, _ = RTF.forward(cfg, rp, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)})
    assert caches is None
    _close(h, rh)

    with torch.inference_mode():
        h, cache = TF.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens)},
                              16)
    rh, rcache = RTF.prefill(cfg, rp, {"tokens": jnp.asarray(tokens,
                                                              jnp.int32)},
                             16)
    _close(h, rh)
    assert sorted(cache) == sorted(rcache) == ["shift_cm", "shift_tm", "wkv"]
    for name in cache:
        assert tuple(cache[name].shape) == rcache[name].shape
        _close(cache[name], rcache[name])

    logits = RTF.logits_from_hidden(cfg, rp, rh[:, -1:])
    for step in range(4):
        tok = np.array(jnp.argmax(logits, axis=-1))          # (B, 1)
        with torch.inference_mode():
            got, cache = TF.decode_step(cfg, tp, cache, torch.from_numpy(tok),
                                        7 + step)
        logits, rcache = RTF.decode_step(cfg, rp, rcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.int32(7 + step))
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got, logits)
    for name in cache:
        _close(cache[name], rcache[name])


def test_decode_updates_the_wkv_cache_in_place(monkeypatch):
    """Each layer's recurrence writes its final state straight into the
    cache it read (`s0` and `s_out` are `cache["wkv"][i]`), so the step
    leaves the cache tensors where they were, with the reference's
    values."""
    from repro_torch.kernels import ops

    cfg = reduced()
    tree = rwkv_numpy_tree(cfg, seed=3)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = P.params_from_reference(tree, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 4))
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens)},
                              16)
    _, rcache = RTF.prefill(cfg, rp, {"tokens": jnp.asarray(tokens,
                                                             jnp.int32)}, 16)
    held = {name: (t, t.data_ptr()) for name, t in cache.items()}
    seen = []
    real = ops.rwkv6_scan_heads

    def spy(r, k, v, w, u, s0=None, s_out=None):
        seen.append((s0.data_ptr(), s_out.data_ptr()))
        return real(r, k, v, w, u, s0, s_out)

    monkeypatch.setattr(ops, "rwkv6_scan_heads", spy)
    tok = np.array([[3], [9]])
    with torch.inference_mode():
        _, out = TF.decode_step(cfg, tp, cache, torch.from_numpy(tok), 4)
    _, rcache = RTF.decode_step(cfg, rp, rcache, jnp.asarray(tok, jnp.int32),
                                jnp.int32(4))
    assert out is cache
    for name, (t, ptr) in held.items():
        assert cache[name] is t and t.data_ptr() == ptr
        _close(cache[name], rcache[name])
    wkv = cache["wkv"]
    assert seen == [(wkv[i].data_ptr(), wkv[i].data_ptr())
                    for i in range(cfg.n_layers)]


def test_cache_matches_reference_layout():
    cfg, rcfg = reduced(), ref_get_config("rwkv6-7b").reduced()
    assert TF.cache_spec(cfg, 128) == tuple(RTF.cache_spec(rcfg, 128))
    got = TF.init_cache(cfg, 3, 128, device="cpu")
    want = RTF.init_cache(rcfg, 3, 128)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype)
        assert not t.any()


def _requests(module, eos: dict | None = None):
    rng = np.random.default_rng(4)
    eos = eos or {}
    return [module.Request(uid=i, prompt=rng.integers(1, 128, n).tolist(),
                           max_new_tokens=6 if i != 4 else 4,
                           eos_id=eos.get(i))
            for i, n in enumerate([5, 5, 5, 8, 8])]


def test_engines_give_the_same_tokens(monkeypatch):
    cfg = reduced()
    tree = rwkv_numpy_tree(cfg, seed=5)
    port = E.ServingEngine(cfg, P.params_from_reference(tree, device="cpu"),
                           max_batch=2, cache_len=16, device="cpu")
    eos = {0: port.run(_requests(E))[0].output[2]}

    margins = []

    def record(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            top2 = torch.topk(logits.reshape(-1, logits.shape[-1]), 2).values
            margins.extend((top2[:, 0] - top2[:, 1]).tolist())
            return out
        return wrapped

    monkeypatch.setattr(TF, "decode_step", record(TF.decode_step))
    monkeypatch.setattr(TF, "logits_from_hidden",
                        record(TF.logits_from_hidden))
    got = E.ServingEngine(cfg, P.params_from_reference(tree, device="cpu"),
                          max_batch=2, cache_len=16,
                          device="cpu").run(_requests(E, eos))
    want = RE.ServingEngine(cfg, jax.tree.map(jnp.asarray, tree),
                            max_batch=2, cache_len=16).run(
        _requests(RE, eos))
    assert [r.output for r in got] == [r.output for r in want]
    assert len(got[0].output) == 3 and got[0].output[-1] == eos[0]
    assert [len(r.output) for r in got[1:]] == [6, 6, 6, 4]
    assert margins and min(margins) > ATOL


def test_full_size_tree_matches_reference_defs():
    cfg, rcfg = get_config("rwkv6-7b"), ref_get_config("rwkv6-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        RP.param_defs(rcfg), is_leaf=RP.is_def)[0]
    port_leaves = list(P.leaves(P.param_defs(cfg)))
    assert [tuple(k.key for k in path) for path, _ in ref_leaves] == \
        [path for path, _ in port_leaves]
    for (_, r), (_, d) in zip(ref_leaves, port_leaves):
        assert tuple(r.shape) == d.shape
        assert np.dtype(r.dtype).name == str(d.dtype).removeprefix("torch.")
        assert r.init == d.init and r.init_scale == d.init_scale
    assert P.param_count(cfg) == RP.param_count(rcfg) == 7_584_878_592


def test_init_params_match_reference_init():
    """The reference's initializers: the same leaves, shapes and dtypes,
    zeros and ones where it puts them (so `w0`, `u` and every `mu_*` start
    at zero), normals of the stated scale elsewhere."""
    cfg = reduced()
    ref = RP.init_params(jax.random.PRNGKey(0),
                         ref_get_config("rwkv6-7b").reduced())
    port = P.init_params(cfg, seed=0, device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    port_leaves = list(P.leaves(port))
    assert [tuple(k.key for k in path) for path, _ in ref_leaves] == \
        [path for path, _ in port_leaves]
    defs = dict(P.leaves(P.param_defs(cfg)))
    for (_, r), (path, t) in zip(ref_leaves, port_leaves):
        assert tuple(r.shape) == tuple(t.shape)
        assert str(r.dtype) == str(t.dtype).removeprefix("torch.")
        if defs[path].init != "normal":
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    lora = port["layers"]["tm"]["lora_A"]
    assert abs(float(lora.std()) * np.sqrt(cfg.d_model) - 1) < 0.1


@pytest.mark.parametrize("quant", ["ternary", "ternary_packed"])
def test_quantized_rwkv_is_refused(quant):
    """The reference's RWKV block reads dense `w` leaves whatever the
    quant mode; the port refuses the modes it would serve wrongly."""
    cfg = reduced().replace(quant=quant)
    for build in (P.param_defs, lambda c: P.init_params(c, device="cpu"),
                  lambda c: P.serving_params(c, device="cpu")):
        with pytest.raises(ValueError, match="dense only"):
            build(cfg)
    with pytest.raises(ValueError, match="dense only"):
        TF.init_cache(cfg, 1, 8, device="cpu")


def test_serve_cli_runs_rwkv_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "rwkv6-7b", "--reduced", "--quant", "dense",
         "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "(dense) on cpu" in out.stdout
    assert '"decode_steps": ' in out.stdout
