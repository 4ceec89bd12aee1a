"""The plain reference computes what the program computes: at a tiny
size in float32 on the CPU its logits equal the program's forward, its
chunked WKV-6 equals the token-by-token recurrence, its int8 optimizer
equals the program's one step, and its ternary codes the program's."""
import pytest
import torch

from bench import reference, weights
from bench.drivers import flat, model_config, nest
from bench.reference import optim8, rwkv6
from bench.reference.common import layer_params
from bench.reference.prec import F32
from bench.reference.quant import ternary
from bench.tests import tiny


def test_chunked_wkv_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, T, H, dh = 2, 70, 3, 8
    r, k, v = (torch.randn(B, T, H, dh, generator=g, dtype=torch.float64)
               for _ in range(3))
    logw = -torch.exp(2 * torch.randn(B, T, H, dh, generator=g,
                                      dtype=torch.float64))
    u = torch.randn(H, dh, generator=g, dtype=torch.float64)
    y1, s1 = rwkv6.wkv_steps(r, k, v, logw, u)
    y2, s2 = rwkv6.wkv(r, k, v, logw, u, chunk=16)
    torch.testing.assert_close(y2, y1, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(s2, s1, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", ["rwkv6-7b", "qwen2.5-14b-ternary"])
def test_reference_logits_equal_the_programs(name):
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import quantize_params

    config = tiny.config(name, "float32")
    model, arch = config["model"], reference.module(config)
    cfg = model_config(model, model["n_layers"])
    dense = weights.draw(config, 3, "cpu", model["n_layers"])
    params = quantize_params(cfg, dense)
    tokens = torch.randint(0, model["vocab"], (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, _, _ = TF.forward(cfg, params, {"tokens": tokens})
        want = TF.logits_from_hidden(cfg, params, h)
        x = dense["embed"]["tokens"][tokens].float()
        consts = arch.consts(model, 12, "cpu")
        for i in range(model["n_layers"]):
            lp = layer_params(dense["layers"], i)
            x = arch.layer(model, lp, x, consts, F32, i)
        got = arch.logits(model, dense["final_norm"]["scale"],
                          dense["lm_head"]["w"], x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ternary_codes_equal_the_programs():
    from repro_torch.core.ternary import ternary_quantize_lm
    w = torch.randn(64, 24, generator=torch.Generator().manual_seed(2))
    codes, alpha = ternary(w)
    pc, pa = ternary_quantize_lm(w)
    assert torch.equal(codes, pc)
    torch.testing.assert_close(alpha, pa, rtol=0, atol=0)


def test_int8_step_equals_the_programs():
    from repro_torch.optim import adamw8bit
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.grad_compress import compress_grads
    g = torch.Generator().manual_seed(3)
    params = {"a": {"w": torch.randn(3, 700, generator=g)},
              "b": torch.randn(40, generator=g)}
    grads = {"a": {"w": torch.randn(3, 700, generator=g)},
             "b": torch.randn(40, generator=g) * 1e-3}
    err = {"a": {"w": torch.zeros(3, 700)}, "b": torch.zeros(40)}
    pg, _ = compress_grads(grads, err)
    pp, st = adamw8bit.apply_updates(params, pg, adamw8bit.init(params),
                                     AdamWConfig(lr=1e-2, grad_clip=1.0))
    fp, fg = flat(params), flat(grads)
    rg = {}
    for k in fg:
        rg[k], _ = optim8.compress(fg[k], torch.zeros_like(fg[k]))
    mu = {k: optim8.zeros_like_moment(p) for k, p in fp.items()}
    nu = {k: optim8.zeros_like_moment(p) for k, p in fp.items()}
    rp, rm, _ = optim8.adamw_step(fp, rg, mu, nu, 1, 1e-2, 1.0)
    for k, v in flat(pp).items():
        torch.testing.assert_close(rp[k], v, rtol=1e-6, atol=1e-7)
    for k, q in flat(st.mu).items():
        torch.testing.assert_close(optim8.dequantize(rm[k]),
                                   adamw8bit._dequantize(q), rtol=1e-6,
                                   atol=1e-9)
    assert nest(rp).keys() == pp.keys()
