"""The port's encoder-decoder (whisper-medium) held against
`repro.models.transformer`.

* The reduced model (2 encoder + 2 decoder layers, 12 frames, layernorm,
  gelu, learned positions, no RoPE) through
  `torch_lm_reference.check_model`, dense and ternary_packed: forward,
  prefill (self-attention K/V and the cross-attention `xk`/`xv` over the
  encoder output) and decode steps within `ATOL` (1e-4).
* Cross-attention reads every encoder frame with no causal mask:
  `blockwise_attention(causal=False)` over 12 keys with a ragged last
  block against the reference's, and the decode step's all-true mask over
  the cached frames against a plain softmax over them.
* Decode leaves `xk`/`xv` as prefill wrote them and adds `dec_pos[pos]`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as RA  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import (ATOL, cfgs, check_model, numpy_batch,  # noqa: E402,E501
                                numpy_tree, to_port)


@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_whisper_matches_reference(quant):
    cache = check_model("whisper-medium", quant)
    assert cache["xk"].shape[2] == 12         # every encoder frame


@pytest.mark.parametrize("block_k", [5, 12, 1024])
def test_cross_attention_has_no_causal_mask(block_k):
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (2, 3, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    got = A.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False, block_k=block_k)
    want = RA.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                  block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # a plain softmax over all 12 keys, grouped queries (GQA 4 -> 2)
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(2, 3, 2, 2, 16), k) / 4.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    plain = np.einsum("bkgqs,bskd->bqkgd", p, v).reshape(2, 3, 4, 16)
    np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=ATOL)
    dec = A.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.ones(12, dtype=torch.bool))
    np.testing.assert_allclose(dec.numpy(), plain[:, :1], rtol=0, atol=ATOL)


def test_decode_keeps_cross_kv_and_reads_dec_pos():
    cfg, _ = cfgs("whisper-medium", "dense")
    tp = P.params_from_reference(numpy_tree(cfg, seed=3), device="cpu")
    batch = to_port(numpy_batch(cfg, 2, 6, 4))
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, tp, batch, 16)
        xk, xv = cache["xk"].clone(), cache["xv"].clone()
        tok = torch.ones((2, 1), dtype=torch.long)
        logits, _ = TF.decode_step(cfg, tp, cache, tok, 6)
        # the step's input is embed(tok) + dec_pos[6]; moving dec_pos[6]
        # (not by a constant, which layernorm removes) must move the logits
        tp["dec_pos"][6] += torch.linspace(-1, 1, cfg.d_model)
        cache["k"][:, :, 6] = 0
        cache["v"][:, :, 6] = 0
        moved, _ = TF.decode_step(cfg, tp, cache, tok, 6)
    assert torch.equal(cache["xk"], xk) and torch.equal(cache["xv"], xv)
    assert (moved - logits).abs().max() > 1e-3
