"""Shared harness of the LM family tests: one arch's port against
`repro.models.transformer` on the same numpy weights and inputs.

`check_model` runs forward, prefill (every cache entry) and decode steps
of the reduced arch (float32, on the CPU, the port's plain kernel
versions) in both frameworks and holds them within `ATOL`.  The weights
come from `test_torch_transformer.numpy_tree` (random packed codes under
`ternary_packed`, not the reference's all-zero init); the reference takes
them as jnp arrays, the port through `params_from_reference`.  The decode
feeds both the reference's greedy tokens.

Tolerance: `ATOL = 1e-4`, as `tests/test_torch_transformer.py` states it:
both run float32 with the same formulas; what differs is the order of
float sums (XLA's against PyTorch's, the Mamba scan's tree order against
the port's loop), ~1e-6 at these widths.  An fp8 cache is compared by its
bytes, which must be equal (`check_model(..., fp8_bytes=True)`).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RTF
from repro_torch.configs import get_config
from repro_torch.models import params as P
from repro_torch.models import transformer as TF

from test_torch_transformer import ATOL, numpy_tree, ref_params

__all__ = ["ATOL", "cfgs", "close", "numpy_batch", "check_model",
           "numpy_tree", "ref_params"]


def cfgs(arch: str, quant: str, **over):
    """The port's and the reference's reduced config of `arch`."""
    return (get_config(arch).reduced().replace(quant=quant, **over),
            ref_get_config(arch).reduced().replace(quant=quant, **over))


def numpy_batch(cfg, B: int, S: int, seed: int) -> dict:
    """Seeded inputs with the arch's stub frontends: tokens, and for a VLM
    vision embeddings and M-RoPE ids whose three streams differ (t, h, w
    as a grid would give them), for an encoder-decoder frame embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = rng.normal(
            0, 0.5, (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        s = np.arange(S)
        batch["positions"] = np.broadcast_to(
            np.stack([s, s // 2, s % 3 + 2 * s])[None], (B, 3, S)).copy()
    if cfg.enc_layers:
        batch["enc_frames"] = rng.normal(
            0, 0.5, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def to_port(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def to_ref(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.float32) for k, v in batch.items()}


def as_numpy(t) -> np.ndarray:
    """A port tensor or reference array as numpy; fp8 as its float32
    values."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.float8_e4m3fn \
            else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == ml_dtypes.float8_e4m3fn else a


def close(got, want, atol: float = ATOL) -> None:
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), rtol=0,
                               atol=atol)


def fp8_bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def check_cache(cache: dict, rcache: dict, fp8: bool) -> None:
    assert sorted(cache) == sorted(rcache)
    for name in rcache:
        assert tuple(cache[name].shape) == tuple(rcache[name].shape), name
        if fp8 and cache[name].dtype == torch.float8_e4m3fn:
            np.testing.assert_array_equal(fp8_bytes(cache[name]),
                                          fp8_bytes(rcache[name]), name)
        else:
            close(cache[name], rcache[name])


def check_model(arch: str, quant: str, *, B: int = 2, S: int = 8,
                cache_len: int = 16, steps: int = 3, seed: int = 1,
                **over) -> dict:
    """Forward, prefill and `steps` decode steps of the reduced `arch`
    against the reference; returns the port's final cache."""
    cfg, rcfg = cfgs(arch, quant, **over)
    fp8 = cfg.kv_cache_dtype == "float8_e4m3fn"
    tree = numpy_tree(cfg, seed=seed)
    rp, tp = ref_params(tree), P.params_from_reference(tree, device="cpu")
    batch = numpy_batch(cfg, B, S, seed + 1)

    with torch.inference_mode():
        h, _ = TF.forward(cfg, tp, to_port(batch))
    rh, _, _ = RTF.forward(rcfg, rp, to_ref(batch))
    close(h, rh)

    with torch.inference_mode():
        h, cache = TF.prefill(cfg, tp, to_port(batch), cache_len)
    rh, rcache = RTF.prefill(rcfg, rp, to_ref(batch), cache_len)
    close(h, rh)
    check_cache(cache, rcache, fp8)

    logits = RTF.logits_from_hidden(rcfg, rp, rh[:, -1:])
    for step in range(steps):
        tok = np.array(jnp.argmax(logits, axis=-1))         # (B, 1)
        with torch.inference_mode():
            got, cache = TF.decode_step(cfg, tp, cache, torch.from_numpy(tok),
                                        S + step)
        logits, rcache = RTF.decode_step(rcfg, rp, rcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.int32(S + step))
        assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
        close(got, logits)
    check_cache(cache, rcache, fp8)
    return cache
