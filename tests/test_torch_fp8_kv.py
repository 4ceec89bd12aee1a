"""The port's fp8 KV cache (`kv_cache_dtype="float8_e4m3fn"`) held against
the reference's.

* The cast: the port's `.to(torch.float8_e4m3fn)` of float32 values gives
  the bytes `ml_dtypes`' `astype(float8_e4m3fn)` gives (what the reference
  stores), bit for bit, on random values across the format's range, its
  subnormals and the rounding midpoints between neighbours; and a prefill's
  fp8 cache equals the `astype` of the same prefill's float32 K/V.
* The model: reduced llama3.2-1b (dense and ternary_packed), hymba (the
  hybrid's self-attention cache) and whisper (the cross-attention
  `xk`/`xv` too) through `torch_lm_reference.check_model(fp8)`: every fp8
  cache entry's bytes equal the reference's after prefill and after the
  decode steps, everything else within `ATOL` (1e-4).
* A decode step reads the fp8 cache as its float32 values.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import cfgs, check_model, numpy_tree  # noqa: E402

FP8 = {"kv_cache_dtype": "float8_e4m3fn"}


def _values() -> np.ndarray:
    rng = np.random.default_rng(0)
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn) \
        .astype(np.float32)
    grid = np.sort(grid[np.isfinite(grid)])
    mids = (grid[1:] + grid[:-1]) / 2           # ties: round to even
    return np.concatenate([
        grid, mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
        rng.normal(0, 1, 4096), rng.uniform(-440, 440, 4096),
        rng.normal(0, 2 ** -8, 1024)]).astype(np.float32)


def test_cast_matches_ml_dtypes_bit_for_bit():
    v = _values()
    got = torch.from_numpy(v).to(torch.float8_e4m3fn).view(torch.uint8)
    want = v.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_cache_is_the_cast_of_its_float32_kv():
    cfg, _ = cfgs("llama3.2-1b", "dense", **FP8)
    tp = P.params_from_reference(numpy_tree(cfg, seed=4), device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)))}
    with torch.inference_mode():
        _, c8 = TF.prefill(cfg, tp, batch, 16)
        _, c32 = TF.prefill(cfg.replace(kv_cache_dtype="compute"), tp, batch,
                            16)
    for name in ("k", "v"):
        assert c8[name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            c8[name].view(torch.uint8).numpy(),
            c32[name].numpy().astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


@pytest.mark.parametrize("arch,quant", [
    ("llama3.2-1b", "dense"), ("llama3.2-1b", "ternary_packed"),
    ("hymba-1.5b", "dense"), ("whisper-medium", "ternary_packed")])
def test_fp8_model_matches_reference(arch, quant):
    cache = check_model(arch, quant, **FP8)
    assert cache["k"].dtype == torch.float8_e4m3fn
    if "xk" in cache:
        assert cache["xk"].dtype == torch.float8_e4m3fn


def test_decode_attention_reads_fp8_as_float32():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(0, 1, (2, 1, 4, 16)).astype(np.float32))
    k8, v8 = (torch.from_numpy(rng.normal(0, 1, (2, 9, 2, 16))
                               .astype(np.float32)).to(torch.float8_e4m3fn)
              for _ in range(2))
    mask = torch.arange(9) < 7
    got = A.decode_attention(q, k8, v8, mask)
    want = A.decode_attention(q, k8.float(), v8.float(), mask)
    assert torch.equal(got, want)
