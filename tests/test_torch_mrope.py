"""The port's M-RoPE and Qwen2-VL held against `repro.models.layers` and
`repro.models.transformer`.

* `mrope_cos_sin` within 1e-6 of the reference's at the published
  sections (16, 24, 24) with head_dim 128 and the reduced ones, on
  positions whose three (t, h, w) streams differ; sections that do not sum
  to head_dim // 2 raise `ValueError` (the reference asserts).
* The reduced qwen2-vl (4 vision positions written over the prompt's
  first four, QKV bias, M-RoPE) through `torch_lm_reference.check_model`,
  dense and ternary_packed, within `ATOL` (1e-4).
* A decode step's default M-RoPE ids are `pos` in all three streams.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import cfgs, check_model, numpy_batch, numpy_tree, to_port  # noqa: E402,E501


@pytest.mark.parametrize("d_head,sections,theta", [
    (128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e6), (64, (8, 12, 12), 1e4)])
def test_mrope_cos_sin_matches_reference(d_head, sections, theta):
    rng = np.random.default_rng(d_head)
    pos = rng.integers(0, 4096, (2, 3, 17))
    cos, sin = L.mrope_cos_sin(torch.from_numpy(pos), d_head, theta, sections)
    rcos, rsin = RL.mrope_cos_sin(jnp.asarray(pos, jnp.int32), d_head, theta,
                                  sections)
    assert cos.shape == (2, 17, d_head // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=0,
                               atol=1e-6)


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="sections"):
        L.mrope_cos_sin(torch.zeros((1, 3, 2), dtype=torch.long), 16, 1e6,
                        (2, 3, 2))


@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_qwen2_vl_matches_reference(quant):
    check_model("qwen2-vl-72b", quant)


def test_decode_default_positions_are_pos_in_every_stream():
    cfg, _ = cfgs("qwen2-vl-72b", "dense")
    tp = P.params_from_reference(numpy_tree(cfg, seed=2), device="cpu")
    batch = to_port(numpy_batch(cfg, 2, 6, 3))
    tok = torch.full((2, 1), 5, dtype=torch.long)
    with torch.inference_mode():
        _, c1 = TF.prefill(cfg, tp, batch, 16)
        _, c2 = TF.prefill(cfg, tp, batch, 16)
        a, _ = TF.decode_step(cfg, tp, c1, tok, 6)
        b, _ = TF.decode_step(cfg, tp, c2, tok, 6,
                              positions=torch.full((2, 3, 1), 6))
    assert torch.equal(a, b)
