"""mellum2-12b-a2.5b through the port's plain paths, against the benchmark's
plain reference (`bench/reference/mellum.py`), in float32 on the CPU.

The reduced config keeps one whole period of the layer pattern (three
windowed layers, window 8, then one full layer with YaRN's rope) and 4
experts top 2, routed dropless, dense and `ternary_packed` (attention and
experts as 2-bit codes).  Held here: the forward; a prefill longer than
the window, then decode steps past it through the two-kind cache, against
the reference's full forward (logits within `ATOL`, as
`tests/test_torch_transformer.py` states it); the YaRN tables against
the formula written out below, the ramp's ends included; the dropless
path equal to the capacity path where nothing drops, and dropping
nothing where the capacity path drops; the grouped expert product's
plain path against a per-expert einsum.  On the card (`cuda`-marked,
skipped without a CUDA device: the kernel has no CPU mode):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mellum.py
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench import weights  # noqa: E402
from bench.reference import mellum as REF  # noqa: E402
from bench.reference.common import layer_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ternary import pack_ternary, unpack_ternary  # noqa: E402
from repro_torch.kernels import expert_matmul as EM  # noqa: E402
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import quantize_params  # noqa: E402

ATOL = 1e-4
SEED = 2 ** 31 + 31


def reduced(quant: str):
    return get_config("mellum2-12b-a2.5b").reduced().replace(quant=quant)


def weights_of(cfg):
    """The dense tree the benchmark draws for `cfg` (its reference's
    layout), and the port's serving tree of it."""
    config = {"reference": "mellum", "model": dataclasses.asdict(cfg)}
    dense = weights.draw(config, SEED, "cpu", cfg.n_layers)
    return config, dense, quantize_params(cfg, dense)


def reference_logits(config: dict, dense: dict, tokens) -> torch.Tensor:
    model = config["model"]
    x = dense["embed"]["tokens"][tokens].float()
    consts = REF.consts(model, tokens.shape[1], "cpu")
    for i in range(model["n_layers"]):
        x = REF.layer(model, layer_params(dense["layers"], i), x, consts,
                      index=i)
    return REF.logits(model, dense["final_norm"]["scale"],
                      dense["lm_head"]["w"], x)


@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_forward_equals_the_reference(quant):
    cfg = reduced(quant)
    assert cfg.n_layers == 4 and cfg.layer_types[-1] == "full_attention"
    config, dense, params = weights_of(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 19),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, _, _ = TF.forward(cfg, params, {"tokens": tokens})
        got = TF.logits_from_hidden(cfg, params, h)
        want = reference_logits(config, dense, tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_prefill_then_decode_past_the_window(quant):
    """20 prompt tokens (past the window of 8, not a multiple of it), then
    12 decode steps: the windowed layers' rolling 8-slot caches wrap."""
    cfg = reduced(quant)
    config, dense, params = weights_of(cfg)
    S, steps = 20, 12
    tokens = torch.randint(0, cfg.vocab, (2, S + steps),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = reference_logits(config, dense, tokens)
        h, cache = TF.prefill(cfg, params, {"tokens": tokens[:, :S]},
                              S + steps)
        assert cache["k_win"].shape[:3] == (3, 2, cfg.swa_window)
        assert cache["k"].shape[:3] == (1, 2, S + steps)
        got = [TF.logits_from_hidden(cfg, params, h)]
        for t in range(steps):
            lg, cache = TF.decode_step(cfg, params, cache,
                                       tokens[:, S + t:S + t + 1], S + t)
            got.append(lg)
    torch.testing.assert_close(torch.cat(got, dim=1), want[:, :S + steps],
                               rtol=0, atol=ATOL)


def yarn_written_out(dh: int, theta: float, factor: float, orig: int,
                     fast: float, slow: float):
    """HF transformers' `_compute_yarn_parameters`, step by step."""
    def corr(rot):
        return dh * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low, high = max(math.floor(corr(fast)), 0), min(math.ceil(corr(slow)),
                                                    dh - 1)
    freq = [theta ** (2 * i / dh) for i in range(dh // 2)]
    inv = []
    for i in range(dh // 2):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        inv.append((1 / (factor * freq[i])) * ramp + (1 / freq[i]) * (1 - ramp))
    return np.array(inv), low, high


@pytest.mark.parametrize("dh,low,high", [(128, 18, 35), (16, 2, 5)])
def test_yarn_tables_follow_the_formula(dh, low, high):
    spec = get_config("mellum2-12b-a2.5b").rope_full
    want, lo, hi = yarn_written_out(dh, spec.theta, spec.factor,
                                    spec.original_max_position_embeddings,
                                    spec.beta_fast, spec.beta_slow)
    assert (lo, hi) == (low, high)
    inv, af = LY.rope_inv_freq(dh, spec)
    np.testing.assert_allclose(inv, want, rtol=1e-12)
    base = 1 / spec.theta ** (np.arange(0, dh, 2) / dh)
    # the ramp's ends: extrapolated up to the low dim, interpolated from
    # the high one, a blend strictly between
    np.testing.assert_allclose(inv[:low + 1], base[:low + 1], rtol=1e-12)
    np.testing.assert_allclose(inv[high:], base[high:] / spec.factor,
                               rtol=1e-12)
    mid = inv[low + 1:high]
    assert len(mid) and np.all(mid < base[low + 1:high]) \
        and np.all(mid > base[low + 1:high] / spec.factor)
    assert af == spec.attention_factor
    pos = torch.arange(300)[None, :]
    cos, sin = LY.rope_spec_cos_sin(pos, dh, spec)
    ang = np.arange(300)[:, None] * want[None, :]
    np.testing.assert_allclose(cos[0].numpy(), af * np.cos(ang), atol=1e-6)
    np.testing.assert_allclose(sin[0].numpy(), af * np.sin(ang), atol=1e-6)


def moe_params(E: int = 4, D: int = 16, F: int = 8, skew: float = 0.0):
    g = torch.Generator().manual_seed(3)
    router = torch.randn(D, E, generator=g) * 0.3
    router[:, 0] += skew
    return {"router": {"w": router}, "experts": {
        "w_gate": torch.randn(E, D, F, generator=g) / D ** 0.5,
        "w_up": torch.randn(E, D, F, generator=g) / D ** 0.5,
        "w_down": torch.randn(E, F, D, generator=g) / F ** 0.5}}


def test_dropless_equals_capacity_where_nothing_drops():
    p = moe_params()
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(4))
    # capacity factor E / k: an expert has a slot for every token
    want, aux_w = MOE.moe_ffn(p, x, n_experts=4, top_k=2,
                              capacity_factor=2.0)
    got, aux = MOE.moe_ffn(p, x, n_experts=4, top_k=2, capacity_factor=2.0,
                           dropless=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(aux, aux_w, rtol=1e-6, atol=0)


def test_skewed_router_drops_nothing():
    """Every token's top two hold expert 0: the capacity path (factor
    1.25) drops past expert 0's slots, the dropless path computes all."""
    p = moe_params(skew=50.0)
    # positive inputs, so the skewed column scores highest for every token
    x = torch.rand(2, 9, 16, generator=torch.Generator().manual_seed(5)) + 0.5
    drops = {}
    for name, kw in (("dropless", dict(dropless=True)), ("capacity", {})):
        MOE.MOE_STATS.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            y, _ = MOE.moe_ffn(p, x, n_experts=4, top_k=2,
                               capacity_factor=1.25, **kw)
        s = MOE.MOE_STATS.summary()
        assert s["calls"] == 1 and s["assignments"] == 18 * 2
        assert s["peak_load"][0] == pytest.approx(18 / (36 / 4))
        drops[name] = (s["dropped"], y)
    MOE.MOE_STATS.reset()
    assert drops["dropless"][0] == 0 and drops["capacity"][0] > 0
    every, _ = MOE.moe_ffn(p, x, n_experts=4, top_k=2, capacity_factor=2.0)
    torch.testing.assert_close(drops["dropless"][1], every, rtol=0,
                               atol=1e-6)
    assert not torch.allclose(drops["capacity"][1], every, atol=1e-3)


def packed_experts(E: int, K: int, N: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(-1, 2, (E, K, N), generator=g).float()
    w2 = torch.stack([pack_ternary(c) for c in codes])
    scale = torch.rand(E, 1, N, generator=g) + 0.5
    return codes, w2, scale


@pytest.mark.parametrize("counts", [(5, 0, 9, 1), (0, 0, 12, 0),
                                    (3, 3, 3, 3), (0, 0, 0, 0)])
def test_grouped_plain_equals_a_per_expert_einsum(counts):
    E, K, N = 4, 24, 10
    codes, w2, scale = packed_experts(E, K, N, sum(counts))
    M = sum(counts)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(6))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    got = EM.expert_matmul(x, w2, scale, offsets)
    which = torch.repeat_interleave(torch.arange(E), torch.tensor(counts))
    want = torch.einsum("mk,mkn->mn", x, codes[which]) * scale[which, 0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(unpack_ternary(w2[0]), codes[0])


def test_grouped_plan_bounds_every_tile_and_refuses_what_it_cannot_take():
    from repro_torch.kernels import cuda_expert_matmul as CE
    rng = np.random.default_rng(8)
    for E, M in ((64, 262144), (64, 7), (4, 0), (8, 1000)):
        p = CE.plan(M, 2304, 896, E, torch.bfloat16)
        assert p.grid == (7, -(-M // 128) + E)
        for _ in range(20):
            counts = rng.multinomial(M, rng.dirichlet(np.ones(E) * 0.3))
            assert sum(-(-int(c) // 128) for c in counts) <= p.grid[1]
    with pytest.raises(TypeError):
        CE.plan(16, 64, 32, 4, torch.float32)
    with pytest.raises(ValueError):
        CE.plan(16, 36, 32, 4, torch.bfloat16)       # K % 8
    with pytest.raises(ValueError):
        CE.plan(16, 64, 32, 4, torch.bfloat16, x_align=8)
    with pytest.raises(ValueError):
        CE.plan(128 * 70000, 64, 32, 4, torch.bfloat16)


# ---------------------------------------------------------------------------
# On the card.
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def inside_envelope(got, x, codes, scale, which) -> bool:
    """Within eps * sqrt(K) * (|x| @ |w|) * |scale| + 1e-6 of the float64
    product, the ternary kernel's stated envelope."""
    K = x.shape[1]
    x64, w64 = x.double(), codes.double()[which]
    s64 = scale.double()[which, 0]
    exact = torch.einsum("mk,mkn->mn", x64, w64) * s64
    bound = float(np.finfo(np.float32).eps) * K ** 0.5 * torch.einsum(
        "mk,mkn->mn", x64.abs(), w64.abs()) * s64.abs() + 1e-6
    return bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("E,K,N,counts", [
    (4, 64, 32, (5, 0, 9, 1)),
    (4, 72, 130, (0, 300, 0, 1)),
    (8, 2304, 896, (1000, 0, 129, 128, 1, 0, 700, 3)),
    (8, 896, 2304, (0, 0, 0, 1000, 0, 0, 0, 0)),
    (64, 256, 144, tuple((i * 37) % 11 * (i % 3) for i in range(64))),
])
def test_grouped_kernel_inside_the_envelope(cuda, E, K, N, counts):
    from repro_torch.kernels import cuda_expert_matmul as CE
    codes, w2, scale = packed_experts(E, K, N, E + K + N)
    M = sum(counts)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(7))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    which = torch.repeat_interleave(torch.arange(E), torch.tensor(counts))
    xc = x.to(cuda, torch.bfloat16)
    n0 = CE.LAUNCHES["expert_matmul"]
    got = EM.expert_matmul(xc, w2.to(cuda), scale.to(cuda),
                           offsets.to(cuda))
    again = EM.expert_matmul(xc, w2.to(cuda), scale.to(cuda),
                             offsets.to(cuda))
    torch.cuda.synchronize()
    assert CE.LAUNCHES["expert_matmul"] == n0 + 2
    assert torch.equal(got, again)
    plain = EM.expert_matmul_plain(xc, w2.to(cuda), scale.to(cuda),
                                   offsets.to(cuda))
    xb = xc.float().cpu()
    assert inside_envelope(got.cpu(), xb, codes, scale, which)
    assert inside_envelope(plain.cpu(), xb, codes, scale, which)


@pytest.mark.cuda
def test_served_reduced_mellum_runs_the_kernels(cuda):
    """The reduced model in bf16, heads widened to 64 (a size the fused
    attention kernel is built for), through `ServingEngine`: every expert
    product on the grouped kernel (3 a layer a prefill), every attention
    call fused, no assignment dropped."""
    from repro_torch.kernels import cuda_attention as CA
    from repro_torch.kernels import cuda_expert_matmul as CE
    from repro_torch.models.params import serving_params
    from repro_torch.serve.lm_engine import Request, ServingEngine
    cfg = reduced("ternary_packed").replace(
        d_head=64, param_dtype="bfloat16", compute_dtype="bfloat16")
    eng = ServingEngine(cfg, serving_params(cfg, 1, cuda), max_batch=4,
                        cache_len=65, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 64).tolist(), 1)
            for i in range(4)]
    CE.reset_launches()
    CA.reset_launches()
    MOE.MOE_STATS.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run(reqs)
    torch.cuda.synchronize()
    assert CE.LAUNCHES["expert_matmul"] == 3 * cfg.n_layers
    assert CA.VARIANT_LAUNCHES == {"fused": cfg.n_layers, "blockwise": 0}
    s = MOE.MOE_STATS.summary()
    MOE.MOE_STATS.reset()
    assert s["calls"] == cfg.n_layers and s["dropped"] == 0
