"""`repro_torch.roofline.memory_model` and `analysis.model_flops` against
the reference.

* At `(n_dev=256, model_shards=16)`, the reference's mesh,
  `analytic_memory_bytes` equals `repro.roofline.memory_model.
  analytic_memory_bytes` in every term of every applicable cell, exactly,
  at each config's default quant and under `ternary_packed` wherever the
  port serves it (all archs but the dense-only RWKV-6 and hymba), with
  the reference roofline runner's microbatches.
* At `(1, 1)`, the port's default, nothing is gathered: each weight term
  is the reference's divided by its FSDP factor 2 and multiplied by the
  16 model shards; every other term is the reference's times 256 (or 16
  for the per-shard gradient term).
* `model_flops` equals the reference's; `Roofline` prices bf16 and f32
  products at their own peaks and has no collective term.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro.roofline.memory_model import (  # noqa: E402
    analytic_memory_bytes as ref_memory,
)
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable  # noqa: E402,E501
from repro_torch.models.params import active_param_count  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import kernel_model as K  # noqa: E402
from repro_torch.roofline.memory_model import analytic_memory_bytes  # noqa: E402,E501

DENSE_ONLY = {"hymba-1.5b", "rwkv6-7b"}
CASES = [(a, q) for a in ARCHS for q in
         (["dense"] if a in DENSE_ONLY else ["dense", "ternary_packed"])]


def reference_mb(cfg, shape) -> int:
    """`repro.launch.roofline_run`'s microbatches on its 16 x 16 mesh."""
    if shape.kind != "train":
        return 1
    return min(16 if cfg.d_model >= 7000 else 8,
               max(1, shape.global_batch // 16))


@pytest.mark.parametrize("arch,quant", CASES)
def test_terms_equal_reference_at_256_devices(arch, quant):
    cfg = get_config(arch).replace(quant=quant)
    rcfg = ref_get_config(arch).replace(quant=quant)
    n = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        mb = reference_mb(cfg, shape)
        port = analytic_memory_bytes(cfg, shape, mb, n_dev=256,
                                     model_shards=16)
        ref = ref_memory(rcfg, REF_SHAPES[name], mb)
        assert port == ref, (name, port, ref)
        n += 1
    assert n == (4 if cfg.sub_quadratic else 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_gathers_nothing(arch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        mb = reference_mb(cfg, shape)
        one = analytic_memory_bytes(cfg, shape, mb)
        pod = analytic_memory_bytes(cfg, shape, mb, 256, 16)
        assert set(one) == set(pod)
        for term, v in one.items():
            if term == "total":
                assert v == pytest.approx(sum(x for t, x in one.items()
                                              if t != "total"), rel=1e-12)
            elif term == "weights":
                assert v == pytest.approx(pod[term] / 2 * 16, rel=1e-12)
            elif term == "grads":
                assert v == pytest.approx(pod[term] * 16, rel=1e-12)
            else:
                assert v == pytest.approx(pod[term] * 256, rel=1e-12)


def test_device_counts_are_checked():
    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    for n_dev, shards in ((0, 1), (16, 0), (24, 16)):
        with pytest.raises(ValueError, match="multiple of"):
            analytic_memory_bytes(cfg, shape, 1, n_dev, shards)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    n = active_param_count(get_config(arch))
    for kind, tokens in (("train", 1048576), ("prefill", 1048576),
                         ("decode", 128)):
        assert A.model_flops(n, tokens, kind) == \
            RA.model_flops(n, tokens, kind)


def test_step_roofline_prices_each_class_at_its_peak():
    r = A.Roofline({"bf16": 2 * K.BF16_FLOP_PER_S, "f32": K.F32_FLOP_PER_S},
                   bytes_accessed=K.HBM_BYTES_PER_S / 2)
    assert r.compute_s == pytest.approx(3.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == 0.0 and r.bound_s == r.compute_s
    assert r.dominant == "compute" and r.flops == \
        2 * K.BF16_FLOP_PER_S + K.F32_FLOP_PER_S
    s = r.summary()
    assert set(RA.Roofline(1.0, 1.0, 0.0).summary()) <= set(s)
    assert A.flop_class(torch.bfloat16) == A.flop_class(torch.float16) \
        == "bf16"
    assert A.flop_class(torch.float32) == "f32"
