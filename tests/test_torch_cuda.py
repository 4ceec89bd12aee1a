"""The CUDA kernels against their plain versions, on the card.

The kernel has no CPU mode, so these tests skip where
`torch.cuda.is_available()` is false.  On a machine with a GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compile.artifact import load_manifest, load_program  # noqa: E402
from repro_torch.core.ternary import unpack_ternary  # noqa: E402
from repro_torch.kernels import circuit_sim as CS  # noqa: E402
from repro_torch.kernels import cuda_circuit_sim as CK  # noqa: E402
from repro_torch.kernels import cuda_packed_popcount as CP  # noqa: E402
from repro_torch.kernels import cuda_rwkv6_scan as CW  # noqa: E402
from repro_torch.kernels import cuda_ternary_matmul as CT  # noqa: E402
from repro_torch.kernels import packed_popcount as PP  # noqa: E402
from repro_torch.kernels import rwkv6_scan as WKV  # noqa: E402
from repro_torch.kernels import ternary_matmul as TM  # noqa: E402

pytestmark = pytest.mark.cuda

TESTS = Path(__file__).parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _population(rng, n_in, G, n_out, P):
    hi = n_in + np.arange(G)
    op = rng.integers(1, 13, size=(P, G))
    in0 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    in1 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    outputs = rng.integers(0, n_in + G, size=(P, n_out))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (op, in0, in1, outputs)]


@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("n_in,G,n_out,P,W", [
    (6, 40, 3, 5, 1), (12, 300, 5, 3, 33), (274, 3020, 4, 1, 130),
    (5, 0, 2, 3, 33), (4, 10, 2, 3, 0)])
def test_kernels_equal_plain(cuda, n_in, G, n_out, P, W, per_individual):
    rng = np.random.default_rng(n_in * 1000 + G + W)
    plan = [torch.from_numpy(a).to(cuda)
            for a in _population(rng, n_in, G, n_out, P)]
    shape = (P, n_in, W) if per_individual else (n_in, W)
    words = torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(cuda)
    torch.testing.assert_close(
        CK.fused_eval_uint(*plan, words, n_in),
        CS.population_eval_uint(*plan, words, n_in), rtol=0, atol=0)
    torch.testing.assert_close(
        CK.simulate_population(*plan, words, n_in),
        CS.simulate_population(*plan, words, n_in), rtol=0, atol=0)


def test_golden_bundles_serve_through_the_kernel(cuda):
    CK.reset_launches()
    rows = load_manifest(TESTS / "golden_emit")
    for row in rows:
        prog = load_program(TESTS / "golden_emit" / row["program"],
                            device=cuda, expect_sha256=row["sha256"])
        fix = np.load(TESTS / "golden" / f"{row['name']}.npz")
        np.testing.assert_array_equal(prog.predict(fix["x"]), fix["labels"])
    assert CK.LAUNCHES["fused_eval_uint"] == len(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 2048, 8192), (8, 2048, 512),
                                   (768, 8192, 2048), (7, 36, 130)])
def test_ternary_matmul_kernel_inside_f32_envelope(cuda, M, K, N, dtype):
    """Kernel and plain version on the card, each inside the f32 envelope
    eps * sqrt(K) * (|x| @ |w|) * |scale| + 1e-6 of the float64 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(M * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)) \
        .to(cuda).to(getattr(torch, dtype))
    w2 = torch.from_numpy(
        rng.integers(-128, 128, (K // 4, N)).astype(np.int8)).to(cuda)
    sc = torch.from_numpy(
        np.abs(rng.normal(1, 0.1, (1, N))).astype(np.float32)).to(cuda)
    before = CT.LAUNCHES["ternary_matmul"]
    got = TM.ternary_matmul(x, w2, sc)
    assert CT.LAUNCHES["ternary_matmul"] == before + 1
    x64, w64, s64 = x.double(), unpack_ternary(w2, torch.float64), sc.double()
    exact = (x64 @ w64) * s64
    bound = float(np.finfo(np.float32).eps) * K ** 0.5 * (
        (x64.abs() @ w64.abs()) * s64.abs()) + 1e-6
    assert ((got.double() - exact).abs() <= bound).all()
    plain = TM.ternary_matmul_plain(x, w2, sc)
    assert ((plain.double() - exact).abs() <= bound).all()


def test_lm_engine_projections_run_through_the_kernel(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.params import serving_params
    from repro_torch.serve.lm_engine import Request, ServingEngine

    cfg = get_config("llama3.2-1b").reduced().replace(quant="ternary_packed")
    eng = ServingEngine(cfg, serving_params(cfg, 0, cuda), max_batch=2,
                        cache_len=32, device=cuda)
    CT.reset_launches()
    reqs = eng.run([Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=4)
                    for i in range(3)])
    forwards = eng.stats.n_prefills + eng.stats.decode_steps
    assert [len(r.output) for r in reqs] == [4, 4, 4]
    assert CT.LAUNCHES["ternary_matmul"] == 7 * cfg.n_layers * forwards


def _ternary_operands(dev, M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)) \
        .to(dev).to(dtype)
    w2 = torch.from_numpy(
        rng.integers(-128, 128, (K // 4, N)).astype(np.int8)).to(dev)
    sc = torch.from_numpy(
        np.abs(rng.normal(1, 0.1, (1, N))).astype(np.float32)).to(dev)
    return x, w2, sc


def _inside_f32_envelope(got, x, w2, sc) -> bool:
    K = x.shape[1]
    x64, w64, s64 = x.double(), unpack_ternary(w2, torch.float64), sc.double()
    exact = (x64 @ w64) * s64
    bound = float(np.finfo(np.float32).eps) * K ** 0.5 * (
        (x64.abs() @ w64.abs()) * s64.abs()) + 1e-6
    return bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [36, 2048, 8192])
@pytest.mark.parametrize("N", [130, 200, 512, 8192])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 16, 64, 65, 256, 768])
def test_ternary_matmul_each_variant_inside_f32_envelope(cuda, M, K, N,
                                                         dtype):
    """Shapes across the plan's thresholds (M 8 | 9, one or many K splits,
    BM 64 | 128) with ragged M, N and K edges, each held to the f32
    envelope by the variant the plan routes it to."""
    x, w2, sc = _ternary_operands(cuda, M, K, N, dtype, M * K + N)
    variant = CT.plan(M, K, N, dtype).variant
    before = dict(CT.VARIANT_LAUNCHES)
    got = TM.ternary_matmul(x, w2, sc)
    assert CT.VARIANT_LAUNCHES[variant] == before[variant] + 1
    assert _inside_f32_envelope(got, x, w2, sc)


@pytest.mark.parametrize("M,K,N,dtype,variant", [
    (8, 2048, 512, torch.bfloat16, "split_k"),
    (1, 8192, 200, torch.float32, "split_k"),
    (8, 36, 130, torch.float32, "split_k"),
    (768, 2048, 512, torch.bfloat16, "tensor_core"),
    (256, 2048, 8192, torch.bfloat16, "tensor_core"),
    (65, 36, 130, torch.bfloat16, "tensor_core"),
    (65, 36, 130, torch.float32, "cuda_core"),
    (768, 8192, 2048, torch.float32, "cuda_core")])
def test_ternary_matmul_two_launches_bit_identical(cuda, M, K, N, dtype,
                                                   variant):
    assert CT.plan(M, K, N, dtype).variant == variant
    x, w2, sc = _ternary_operands(cuda, M, K, N, dtype, 7)
    assert torch.equal(TM.ternary_matmul(x, w2, sc),
                       TM.ternary_matmul(x, w2, sc))


def test_unaligned_bf16_x_runs_the_cuda_core_kernel(cuda):
    M, K, N = 64, 2048, 512
    x, w2, sc = _ternary_operands(cuda, M, K, N, torch.bfloat16, 3)
    buf = torch.empty(M * K + 1, dtype=torch.bfloat16, device=cuda)
    xu = buf[1:].view(M, K)
    xu.copy_(x)
    before = CT.VARIANT_LAUNCHES["cuda_core"]
    got = TM.ternary_matmul(xu, w2, sc)
    assert CT.VARIANT_LAUNCHES["cuda_core"] == before + 1
    assert _inside_f32_envelope(got, x, w2, sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_engine_launches_counted_by_variant(cuda, dtype):
    """Decode steps (M <= 8) run split-K; prefills of 2 x 12 tokens run the
    tensor cores in bf16 and the CUDA-core kernel in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import serving_params
    from repro_torch.serve.lm_engine import Request, ServingEngine

    cfg = get_config("llama3.2-1b").reduced().replace(
        quant="ternary_packed", param_dtype=dtype, compute_dtype=dtype)
    eng = ServingEngine(cfg, serving_params(cfg, 0, cuda), max_batch=2,
                        cache_len=32, device=cuda)
    CT.reset_launches()
    reqs = eng.run([Request(uid=i, prompt=list(range(1 + i, 13 + i)),
                            max_new_tokens=4) for i in range(4)])
    per_forward = 7 * cfg.n_layers
    st = eng.stats
    assert [len(r.output) for r in reqs] == [4] * 4
    prefill = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    assert CT.VARIANT_LAUNCHES == {
        "split_k": per_forward * st.decode_steps,
        prefill: per_forward * st.n_prefills,
        ({"tensor_core", "cuda_core"} - {prefill}).pop(): 0}
    assert CT.LAUNCHES["ternary_matmul"] == per_forward * (
        st.decode_steps + st.n_prefills)


@pytest.mark.parametrize("B,W", [(1, 1), (256, 17), (1000, 3), (65536, 32),
                                 (7, 0), (3, 100)])
def test_packed_popcount_kernel_bit_exact(cuda, B, W):
    rng = np.random.default_rng(B * 100 + W)
    words = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64) \
        .astype(np.uint32)
    wt = torch.from_numpy(words.view(np.int32)).to(cuda)
    before = CP.LAUNCHES["packed_popcount"]
    got = PP.packed_popcount(wt)
    assert CP.LAUNCHES["packed_popcount"] == before + 1
    torch.testing.assert_close(got, PP.packed_popcount_plain(wt), rtol=0,
                               atol=0)
    edge = torch.from_numpy(np.array([[0, 0xFFFFFFFF, 1, 0x80000000]],
                                     np.uint32).view(np.int32)).to(cuda)
    assert PP.packed_popcount(edge).tolist() == [34]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("BH,T,dh", [(1, 1, 16), (3, 7, 16), (512, 96, 64),
                                     (512, 1, 64), (2, 512, 64),
                                     (5, 33, 16)])
def test_rwkv6_scan_kernel_inside_f32_envelope(cuda, BH, T, dh, with_s0):
    """Kernel and plain version on the card, each inside the envelope
    eps * (dh + 2T + 4) * |recurrence on absolute values| of the float64
    recurrence (first-order float32 rounding of the dh-term sums and of
    the state carried over T tokens, doubled), at decays U(0.01, 0.999)."""
    rng = np.random.default_rng(BH * T + dh)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    r, k, v = (t(rng.standard_normal((BH, T, dh))) for _ in range(3))
    args = (r, k, v, t(rng.uniform(0.01, 0.999, (BH, T, dh))),
            t(rng.normal(0, 0.5, (BH, dh))),
            t(rng.standard_normal((BH, dh, dh))) if with_s0 else None)
    before = CW.LAUNCHES["rwkv6_scan"]
    got = WKV.rwkv6_scan(*args)
    assert CW.LAUNCHES["rwkv6_scan"] == before + 1
    plain = WKV.rwkv6_scan_plain(*args)
    f64 = [None if a is None else a.double() for a in args]
    exact = WKV.rwkv6_scan_plain(*f64)
    env = WKV.rwkv6_scan_plain(*[None if a is None else a.abs()
                                 for a in f64])
    gamma = float(np.finfo(np.float32).eps) * (dh + 2 * T + 4)
    for g, p, e, m in zip(got, plain, exact, env):
        assert ((g.double() - e).abs() <= gamma * m).all()
        assert ((p.double() - e).abs() <= gamma * m).all()


def test_rwkv6_scan_kernel_split_equals_one_pass(cuda):
    rng = np.random.default_rng(11)
    BH, T, dh, cut = 512, 96, 64, 40
    r, k, v, w = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        *(rng.standard_normal((BH, T, dh)) for _ in range(3)),
        rng.uniform(0.01, 0.999, (BH, T, dh))))
    u = torch.from_numpy(rng.normal(0, 0.5, (BH, dh)).astype(np.float32)) \
        .to(cuda)
    y, s = WKV.rwkv6_scan(r, k, v, w, u)
    y1, s1 = WKV.rwkv6_scan(*(a[:, :cut].contiguous() for a in (r, k, v, w)),
                            u)
    y2, s2 = WKV.rwkv6_scan(*(a[:, cut:].contiguous() for a in (r, k, v, w)),
                            u, s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(s2, s)


def test_rwkv_engine_scans_run_through_the_kernel(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serve.lm_engine import Request, ServingEngine

    cfg = get_config("rwkv6-7b").reduced()
    eng = ServingEngine(cfg, init_params(cfg, 0, cuda), max_batch=2,
                        cache_len=32, device=cuda)
    CW.reset_launches()
    reqs = eng.run([Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=4)
                    for i in range(3)])
    forwards = eng.stats.n_prefills + eng.stats.decode_steps
    assert [len(r.output) for r in reqs] == [4, 4, 4]
    assert CW.LAUNCHES["rwkv6_scan"] == cfg.n_layers * forwards


@pytest.mark.parametrize("W", [0, 1, 2, 3, 4, 5, 8, 9, 17, 31, 32, 33, 63,
                               64, 65, 100, 1000])
def test_packed_popcount_every_design_bit_exact(cuda, W):
    """Odd B, so a `rows` block's run and the flat stream end mid-vector;
    W > 64 runs the `warp` design."""
    B = 333
    rng = np.random.default_rng(W)
    wt = torch.from_numpy(rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).to(cuda)
    design = CP.plan(B, W, wt.data_ptr()).design
    assert design == ("rows" if W <= CP.ROWS_MAX_W else "warp")
    before = CP.DESIGN_LAUNCHES[design]
    got = PP.packed_popcount(wt)
    assert CP.DESIGN_LAUNCHES[design] == before + 1
    torch.testing.assert_close(got, PP.packed_popcount_plain(wt), rtol=0,
                               atol=0)


@pytest.mark.parametrize("B,W", [(65536, 9), (333, 32), (1001, 70)])
def test_packed_popcount_plane_off_a_16_byte_boundary(cuda, B, W):
    """A contiguous view 4 bytes into its storage loads word by word."""
    rng = np.random.default_rng(B + W)
    flat = torch.from_numpy(rng.integers(0, 2 ** 32, B * W + 1,
                                         dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(cuda)
    wt = flat[1:].view(B, W)
    assert wt.is_contiguous() and not CP.plan(B, W, wt.data_ptr()).vec16
    torch.testing.assert_close(PP.packed_popcount(wt),
                               PP.packed_popcount_plain(wt), rtol=0, atol=0)


def _model_layout(cuda, rng, B, T, H, dh, dtype, offset=0):
    """r, k, v as (B, T, H, dh) slices of one wider projection (starting
    `offset` elements in), w float32 with decays log-uniform over
    (1e-12, 0.999), u (H, dh)."""
    D = H * dh
    big = torch.from_numpy(rng.standard_normal(
        (B, T, 3 * D + offset)).astype(np.float32)).to(cuda).to(dtype)
    r, k, v = (big[..., offset + x * D: offset + (x + 1) * D]
               .unflatten(-1, (H, dh)) for x in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(
        np.log(1e-12), np.log(0.999), (B, T, H, dh))).astype(np.float32)
    ).to(cuda)
    u = torch.from_numpy(rng.normal(0, 0.5, (H, dh)).astype(np.float32)
                         ).to(cuda)
    return r, k, v, w, u


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H,dh", [(8, 96, 64, 64), (8, 1, 64, 64),
                                      (3, 13, 5, 64), (2, 0, 3, 64),
                                      (4, 13, 4, 16), (1, 96, 2, 16)])
def test_rwkv6_scan_model_layout_inside_f32_envelope(cuda, B, T, H, dh,
                                                     dtype, offset):
    """The model's (B, T, H, dh) views (strided, bf16 or f32, u shared by
    the batch, T past and short of a chunk, T = 0, decays down to 1e-12),
    from a state: the kernel inside the envelope of the float64
    recurrence, as `test_rwkv6_scan_kernel_inside_f32_envelope` holds it;
    off a 16-byte boundary (T > 0) it stages element by element."""
    rng = np.random.default_rng(B * T + H + dh + offset)
    args = _model_layout(cuda, rng, B, T, H, dh, dtype, offset)
    s0 = torch.from_numpy(rng.standard_normal((B, H, dh, dh))
                          .astype(np.float32)).to(cuda)
    design = CW.plan(*args, s0).design
    if T:                            # an empty view's address says nothing
        assert design == ("element" if offset else "cp_async")
    before = CW.DESIGN_LAUNCHES[design]
    y, s = WKV.rwkv6_scan(*args, s0)
    assert CW.DESIGN_LAUNCHES[design] == before + 1
    f64 = [a.double() for a in (*args, s0)]
    exact = WKV.rwkv6_scan_plain(*f64)
    env = WKV.rwkv6_scan_plain(*[a.abs() for a in f64])
    gamma = float(np.finfo(np.float32).eps) * (dh + 2 * T + 4)
    for g, e, m in zip((y, s), exact, env):
        assert ((g.double() - e).abs() <= gamma * m).all()


@pytest.mark.parametrize("T", [1, 13, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_scan_state_in_place_bit_identical(cuda, T, dtype):
    """The final state written over s0 (the decode cache) equals the run
    into a fresh state, bit for bit, and y too."""
    rng = np.random.default_rng(T)
    args = _model_layout(cuda, rng, 8, T, 64, 64, dtype)
    s0 = torch.from_numpy(rng.standard_normal((8, 64, 64, 64))
                          .astype(np.float32)).to(cuda)
    y, s = WKV.rwkv6_scan(*args, s0)
    cache = s0.clone()
    y2, s2 = WKV.rwkv6_scan(*args, cache, cache)
    assert s2 is cache
    assert torch.equal(y2, y) and torch.equal(cache, s)


def test_rwkv6_scan_model_layout_split_equals_one_pass(cuda):
    """A split off the chunk boundaries, in the model's layout."""
    rng = np.random.default_rng(12)
    r, k, v, w, u = _model_layout(cuda, rng, 8, 96, 64, 64, torch.bfloat16)
    y, s = WKV.rwkv6_scan(r, k, v, w, u)
    y1, s1 = WKV.rwkv6_scan(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u)
    y2, s2 = WKV.rwkv6_scan(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u,
                            s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(s2, s)


def test_rwkv_decode_updates_the_cache_in_place(cuda):
    """A decode step writes each layer's WKV state into the cache it was
    given, through the kernel's cp.async staging."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params

    cfg = get_config("rwkv6-7b").reduced()
    params = init_params(cfg, 0, cuda)
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, params, {"tokens": torch.tensor(
            [[1, 2, 3], [4, 5, 6]], device=cuda)}, 16)
        wkv, before = cache["wkv"], cache["wkv"].clone()
        CW.reset_launches()
        TF.decode_step(cfg, params, cache, torch.tensor([[7], [8]],
                                                        device=cuda), 3)
    assert cache["wkv"] is wkv and not torch.equal(wkv, before)
    assert CW.DESIGN_LAUNCHES == {"cp_async": cfg.n_layers, "element": 0}


PAST_LIMIT = 30_000     # dead gates that push a plan past shared memory


def _past_limit(plan):
    """`plan` with PAST_LIMIT dead BUF gates appended (reading node 0): the
    same outputs, but a plane and schedule too large for shared memory, so
    the routing takes the global-scratch walk."""
    op, in0, in1, outputs = plan
    P = op.shape[0]
    pad = np.full((P, PAST_LIMIT), 3, np.int32)
    zero = np.zeros((P, PAST_LIMIT), np.int32)
    return [np.ascontiguousarray(np.concatenate([a, b], axis=1))
            for a, b in ((op, pad), (in0, zero), (in1, zero))] + [outputs]


def _both_variants_equal_plain(dev, plan, words, n_in, variant,
                               schedule=None):
    plan = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in plan]
    P, G = plan[0].shape
    assert CK.route(P, G, words.shape[-1], n_in, plan[3].shape[1],
                    None).variant == variant
    before = dict(CK.VARIANT_LAUNCHES)
    got = CK.fused_eval_uint(*plan, words, n_in, schedule=schedule)
    words_out = CK.simulate_population(*plan, words, n_in, schedule=schedule)
    launched = 2 if words.shape[-1] and P else 0
    assert CK.VARIANT_LAUNCHES[variant] == before[variant] + launched
    assert sum(CK.VARIANT_LAUNCHES.values()) == sum(before.values()) + \
        launched
    assert torch.equal(got, CS.population_eval_uint(*plan, words, n_in))
    assert torch.equal(words_out, CS.simulate_population(*plan, words, n_in))


def _words(dev, rng, shape):
    return torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("variant", ["shared_plane", "global_scratch"])
@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("n_in,G,n_out,P,W", [
    (6, 40, 3, 5, 1), (32, 4096, 8, 64, 33), (8, 512, 32, 3, 2048),
    (5, 0, 2, 3, 33), (4, 10, 2, 3, 0), (12, 300, 0, 2, 65)])
def test_level_and_global_walks_equal_plain(cuda, n_in, G, n_out, P, W,
                                            per_individual, variant):
    """Unsorted random plans (wide, shallow levels), gateless plans, W 0
    and 1, 0 and 32 outputs, through each design; the global-scratch walk
    by appending dead gates past the shared-memory limit."""
    if variant == "global_scratch" and P * W > 64 * 33:
        P = 2                  # the plain version walks 30,000 more gates
    rng = np.random.default_rng(n_in * 1000 + G + W + P)
    plan = _population(rng, n_in, G, n_out, P)
    if n_out:
        plan[3][:, 0] = n_in - 1          # an output tapping an input
    if variant == "global_scratch":
        plan = _past_limit(plan)
    shape = (P, n_in, W) if per_individual else (n_in, W)
    _both_variants_equal_plain(cuda, plan, _words(cuda, rng, shape), n_in,
                               variant)


def test_wide_gateless_plane_takes_the_global_walk(cuda):
    rng = np.random.default_rng(2)
    n_in = 60_000
    plan = _population(rng, n_in, 0, 4, 2)
    _both_variants_equal_plain(cuda, plan, _words(cuda, rng, (n_in, 1)),
                               n_in, "global_scratch")


@pytest.mark.parametrize("variant", ["shared_plane", "global_scratch"])
def test_golden_programs_through_each_walk(cuda, variant):
    rows = load_manifest(TESTS / "golden_emit")
    for row in rows:
        prog = load_program(TESTS / "golden_emit" / row["program"],
                            device=cuda, expect_sha256=row["sha256"])
        fix = np.load(TESTS / "golden" / f"{row['name']}.npz")
        x = np.tile(fix["x"], (24, 1))                 # 2,304 readings
        words = prog.pack_input_bits(prog.binarize(x))
        ir = prog.ir
        plan = [np.asarray(a, np.int32)[None]
                for a in (ir.op, ir.in0, ir.in1, ir.outputs)]
        if variant == "global_scratch":
            plan = _past_limit(plan)
            sched = None
        else:
            sched = prog.schedule
        _both_variants_equal_plain(cuda, plan, words, ir.n_inputs, variant,
                                   schedule=sched)
        got = CK.fused_eval_uint(
            *[torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
              for a in plan], words, ir.n_inputs, schedule=sched)
        np.testing.assert_array_equal(
            got[0, : x.shape[0]].cpu().numpy()[:96], fix["labels"])


def test_program_serving_runs_the_level_walk(cuda):
    """predict, scores and the fleet launch of the golden tenants all go
    through the shared-plane walk, with the program's own schedule."""
    from repro_torch.kernels import dispatch as D

    CK.reset_launches()
    rows = load_manifest(TESTS / "golden_emit")
    progs = [load_program(TESTS / "golden_emit" / r["program"], device=cuda,
                          expect_sha256=r["sha256"]) for r in rows]
    xs = [np.load(TESTS / "golden" / f"{r['name']}.npz")["x"] for r in rows]
    for prog, x in zip(progs, xs):
        prog.predict(x)
        prog.scores(prog.binarize(x))
    fused = D.fleet_eval_words(
        [p.plan() for p in progs],
        [p.pack_input_bits(p.binarize(x)) for p, x in zip(progs, xs)],
        device=cuda)
    for prog, x, lab in zip(progs, xs, fused):
        np.testing.assert_array_equal(lab[: x.shape[0]], prog.predict(x))
    n = len(rows)
    assert CK.LAUNCHES == {"fused_eval_uint": 2 * n,
                           "simulate_population": n,
                           "fleet_eval_words": 1}
    assert CK.VARIANT_LAUNCHES == {"shared_plane": 3 * n + 1,
                                   "global_scratch": 0}
    # programs and the fleet carry their levels: no schedule kernel ran
    assert CK.SCHEDULE_LAUNCHES == {"gate_levels": 0, "schedule": 0}


@pytest.mark.parametrize("n_in,G,P", [
    (32, 4096, 64), (6, 40, 5), (5, 0, 3), (1, 1, 1), (16, 20000, 2),
    (40000, 300, 3)])
def test_level_kernel_equals_plain(cuda, n_in, G, P):
    """Levels of unsorted random rows (wide and shallow), of deep chains
    (every gate reads the one before), and of gateless rows."""
    rng = np.random.default_rng(G + P)
    op, in0, in1, _ = _population(rng, n_in, G, 1, P)
    if P == 2:                                  # one deep chain row
        in0[1] = n_in + np.arange(G) - 1
        in0[1, 0] = 0
    before = CK.SCHEDULE_LAUNCHES["gate_levels"]
    got = CK.gate_levels(torch.from_numpy(in0).to(cuda),
                         torch.from_numpy(in1).to(cuda), n_in)
    assert CK.SCHEDULE_LAUNCHES["gate_levels"] == before + int(G > 0)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  CS.gate_levels(in0, in1, n_in))


def test_level_kernel_gives_the_golden_levels(cuda):
    for row in load_manifest(TESTS / "golden_emit"):
        prog = load_program(TESTS / "golden_emit" / row["program"],
                            device="cpu", expect_sha256=row["sha256"])
        ir = prog.ir
        got = CK.gate_levels(torch.from_numpy(ir.in0[None]).to(cuda),
                             torch.from_numpy(ir.in1[None]).to(cuda),
                             ir.n_inputs)
        np.testing.assert_array_equal(got[0].cpu().numpy(), ir.levels)


@pytest.mark.parametrize("n_in,G,n_out,P", [(32, 4096, 8, 64),
                                            (274, 3020, 4, 3),
                                            (3, 20000, 2, 2),
                                            (5, 0, 2, 2)])
def test_schedule_on_the_card_equals_the_cpu_build(cuda, n_in, G, n_out, P):
    """The two schedule kernels against the tensor-op build: the same
    depth, widest level, slots and buffers, bit for bit."""
    rng = np.random.default_rng(n_in + G)
    plan = _population(rng, n_in, G, n_out, P)
    before = CK.SCHEDULE_LAUNCHES["schedule"]
    on_card = CK.schedule(*[torch.from_numpy(a).to(cuda) for a in plan[:3]],
                          n_in, device=cuda)
    assert CK.SCHEDULE_LAUNCHES["schedule"] == before + int(G > 0)
    on_cpu = CK.schedule(*plan[:3], n_in, device="cpu")
    assert (on_card.depth, on_card.width) == (on_cpu.depth, on_cpu.width)
    assert torch.equal(on_card.rank.cpu(), on_cpu.rank)
    assert torch.equal(on_card.program.cpu(), on_cpu.program)


@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_word_plane_off_a_16_byte_boundary(cuda, offset, per_individual):
    """A contiguous word view that starts mid-allocation (a device split of
    the word axis gives one) loads word by word, not in 16-byte quads."""
    rng = np.random.default_rng(offset)
    n_in, G, n_out, P, W = 12, 300, 5, 3, 2048
    plan = _population(rng, n_in, G, n_out, P)
    # whole quads of columns: the 16-byte loads would apply if aligned
    sched = CK.schedule(*plan[:3], n_in, device="cpu")
    assert CK.route(P, G, W, n_in, n_out, sched).columns % 4 == 0
    shape = (P, n_in, W) if per_individual else (n_in, W)
    flat = _words(cuda, rng, (int(np.prod(shape)) + offset,))
    words = flat[offset:].view(shape)
    assert words.is_contiguous() and words.data_ptr() % 16
    _both_variants_equal_plain(cuda, plan, words, n_in, "shared_plane")


# -- the campaign slice's callers of the gate walk ---------------------------
def _port_tnn_problem(device, name="cardio"):
    """`TNNApproxProblem` of a golden TNN on `device`, its PC libraries
    built from the exact and truncated popcount builders."""
    from repro_torch.core import circuits as C
    from repro_torch.core import pcc
    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import abc_binarize
    from repro_torch.data.tabular import make_dataset

    tnn = T.load_tnn(TESTS / "golden_emit" / f"{name}_tnn.npz")
    ds = make_dataset(name)
    sizes = sorted({(p, n) for p, n in tnn.hidden_sizes() if p and n})
    libs = {}
    for n in sorted({k for s in sizes for k in s} | {tnn.out_nnz}):
        libs[n] = [C.popcount_netlist(n)] + [
            C.truncated_popcount_netlist(n, d) for d in range(1, n - 1)]
        for nl in libs[n]:
            nl.meta["mae"] = float(nl.meta.get("drop", 0)) / 2
    lib = pcc.build_pcc_library(sizes, libs, n_samples=4000, device=device)
    return T.TNNApproxProblem(
        tnn=tnn, pcc_lib=lib, pc_out_lib=pcc.pc_pareto(libs[tnn.out_nnz]),
        xbin=abc_binarize(ds.x_train, tnn.thresholds, device=device),
        y=ds.y_train, device=device)


@pytest.mark.parametrize("n", [3, 9, 20])
def test_population_pc_errors_on_card_equal_cpu(cuda, n):
    """CGP's fitness call: (mae, wcae) of a random population against true
    popcounts, on the card equal to the CPU's plain version."""
    from repro_torch.core import circuits as C
    from repro_torch.kernels import dispatch as D

    rng = np.random.default_rng(n)
    pop = C.random_netlist_population(rng, n, 60, C.popcount_width(n), 5)
    packed, true = C.eval_vectors(n, n_samples=5000)
    before = CK.LAUNCHES["fused_eval_uint"]
    got = D.population_pc_errors(pop, packed, true, devices=[cuda])
    assert CK.LAUNCHES["fused_eval_uint"] == before + 1
    want = D.population_pc_errors(pop, packed, true, devices=["cpu"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_schedule_take_serves_gathered_rows(cuda):
    """A library's schedule gathered by `Schedule.take` runs the gathered
    rows as a schedule built for them does, with no build."""
    rng = np.random.default_rng(7)
    plan = [torch.from_numpy(a).to(cuda)
            for a in _population(rng, 6, 80, 3, 9)]
    lib = CK.schedule(*plan[:3], 6, device=cuda)
    rows = torch.tensor([4, 0, 4, 8, 2, 2, 7], device=cuda)
    sub = [a.index_select(0, rows) for a in plan]
    words = _words(cuda, rng, (rows.numel(), 6, 33))
    builds = CK.SCHEDULE_LAUNCHES["schedule"]
    taken = CK.fused_eval_uint(*sub, words, 6, schedule=lib.take(rows))
    assert CK.SCHEDULE_LAUNCHES["schedule"] == builds
    own = CK.fused_eval_uint(*sub, words, 6,
                             schedule=CK.schedule(*sub[:3], 6, device=cuda))
    assert torch.equal(taken, own)
    assert torch.equal(taken, CS.population_eval_uint(*sub, words, 6))


@pytest.mark.parametrize("name", ["cardio", "arrhythmia"])
def test_tnn_objective_on_card_equals_cpu(cuda, name):
    """`TNNApproxProblem.objective` on the card: one launch a call, no
    schedule built, objectives equal to the CPU's bit for bit."""
    card = _port_tnn_problem(cuda, name)
    cpu = _port_tnn_problem("cpu", name)
    rng = np.random.default_rng(3)
    pop = rng.integers(0, card.domains()[None, :], size=(40, card.n_genes))
    before = (CK.LAUNCHES["fused_eval_uint"], dict(CK.SCHEDULE_LAUNCHES))
    got = card.objective(pop)
    assert (CK.LAUNCHES["fused_eval_uint"], CK.SCHEDULE_LAUNCHES) == (
        before[0] + 1, before[1])
    np.testing.assert_array_equal(got, cpu.objective(pop))


def test_qat_step_on_card_equals_cpu(cuda):
    """One QAT step from the same parameters and batch on the card and on
    the CPU: loss within 1e-6 relative, gradients within 1e-6 * max|g|.
    AdamW's first update is g / (|g| + eps) * lr, so an entry whose
    gradient is noise may move by up to 2 lr apart; every entry whose
    gradient stands 1e-4 * max|g| clear of the noise agrees within 1e-6."""
    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import abc_binarize, abc_fit_thresholds
    from repro_torch.data.tabular import make_dataset
    from repro_torch.optim import adamw

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    ds = make_dataset("arrhythmia")
    F, H, Cc = ds.spec.topology
    rng = np.random.default_rng(0)
    arrays = {"w1": rng.normal(0, 0.7, (F, H)),
              "w2": rng.normal(0, 0.7, (H, Cc))}
    idx = rng.permutation(ds.y_train.shape[0])[:64]
    thr = abc_fit_thresholds(ds.x_train)
    cfg = T.TNNTrainConfig(n_hidden=H, lr=1e-2)
    ocfg = adamw.AdamWConfig(lr=cfg.lr, grad_clip=1.0)
    out = []
    for dev in ("cpu", cuda):
        params = T.params_from_arrays(arrays, dev)
        xb = abc_binarize(ds.x_train[idx], thr, device=dev)
        y = torch.from_numpy(ds.y_train[idx].astype(np.int64)).to(dev)
        loss, grads = T.loss_and_grads(params, xb, y, cfg.threshold, H)
        new, state, _ = T.train_step(params, adamw.init(params), xb, y, cfg,
                                     ocfg)
        assert int(state.step) == 1
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                    {k: p.cpu() for k, p in new.items()}))
    (l_cpu, g_cpu, p_cpu), (l_dev, g_dev, p_dev) = out
    assert abs(l_dev - l_cpu) <= 1e-6 * abs(l_cpu)
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    for k in g_cpu:
        torch.testing.assert_close(g_dev[k], g_cpu[k], rtol=0,
                                   atol=1e-6 * g_max)
        clear = g_cpu[k].abs() > 1e-4 * g_max
        torch.testing.assert_close(p_dev[k][clear], p_cpu[k][clear], rtol=0,
                                   atol=1e-6)
        assert float((p_dev[k] - p_cpu[k]).abs().max()) <= 2 * cfg.lr


def test_lowered_classifier_serves_on_card_as_on_cpu(cuda):
    from repro_torch.compile.ir import lower_classifier
    from repro_torch.compile.program import CircuitProgram
    from repro_torch.core import tnn as T
    from repro_torch.data.tabular import make_dataset
    from repro_torch.serve.engine import CircuitServingEngine

    tnn = T.load_tnn(TESTS / "golden_emit" / "arrhythmia_tnn.npz")
    cc = lower_classifier(tnn, *T.exact_netlists(tnn))
    x = np.tile(make_dataset("arrhythmia").x_test, (12, 1))
    CK.reset_launches()
    card = CircuitServingEngine(CircuitProgram.from_classifier(cc, cuda),
                                max_batch=1024).classify_stream(x)
    assert CK.LAUNCHES["fused_eval_uint"] == -(-x.shape[0] // 1024)
    cpu = CircuitServingEngine(CircuitProgram.from_classifier(cc, "cpu"),
                               max_batch=1024).classify_stream(x)
    np.testing.assert_array_equal(card, cpu)
    xb = CircuitProgram.from_classifier(cc, "cpu").binarize(x[:512]).numpy()
    np.testing.assert_array_equal(card[:512], T.predict_exact(tnn, xb))


@pytest.mark.parametrize("mode", ["replicas_2", "megakernel"])
def test_fleet_serves_golden_tenants_on_card(cuda, mode):
    from repro_torch.serve import ClassifierFleet

    kw = {"replicas": 2} if mode == "replicas_2" else {"megakernel": True}
    fleet = ClassifierFleet.from_emit_dir(TESTS / "golden_emit", device=cuda,
                                          autostart=False, **kw)
    CK.reset_launches()
    handles = {}
    for name in fleet.tenants:
        fix = np.load(TESTS / "golden" / f"{name}.npz")
        handles[name] = (fix["labels"], fleet.submit_many(name, fix["x"])[0])
    fleet.start()
    try:
        fleet.flush(timeout=120.0)
        for name, (labels, reqs) in handles.items():
            np.testing.assert_array_equal(
                [r.result(60.0) for r in reqs], labels, err_msg=name)
        assert fleet.errors == []
        s = fleet.stats_summary()
    finally:
        fleet.shutdown(drain=True)
    assert {row["device"] for row in s["tenants"].values()} == {str(cuda)}
    assert CK.VARIANT_LAUNCHES["global_scratch"] == 0
    if mode == "megakernel":
        assert CK.LAUNCHES["fused_eval_uint"] == 0
        assert CK.LAUNCHES["fleet_eval_words"] == \
            s["megakernel"]["launches"] > 0
    else:
        assert CK.LAUNCHES["fleet_eval_words"] == 0
        assert CK.LAUNCHES["fused_eval_uint"] == s["fleet"]["n_batches"] > 0


def test_fleet_workers_serve_on_card(cuda):
    from repro_torch.serve import ClassifierFleet

    fleet = ClassifierFleet.from_emit_dir(TESTS / "golden_emit", device=cuda,
                                          workers=1, deadline_ms=200.0)
    try:
        host = fleet._worker_hosts[str(cuda)]
        before = host.launches()[0]["launches"]["fused_eval_uint"]
        for name in fleet.tenants:
            fix = np.load(TESTS / "golden" / f"{name}.npz")
            reqs, _, _ = fleet.submit_many(name, fix["x"])
            np.testing.assert_array_equal(
                [r.result(60.0) for r in reqs], fix["labels"], err_msg=name)
        after = host.launches()[0]["launches"]["fused_eval_uint"]
        assert after - before >= len(fleet.tenants)
        assert fleet.errors == []
    finally:
        fleet.shutdown()


def test_mlp_baseline_on_card_as_on_cpu(cuda):
    from repro_torch.core import baselines as B
    from repro_torch.data.tabular import DATASETS, make_dataset

    ds = make_dataset("redwine")
    hidden = DATASETS["redwine"].mlp_topology[1]
    for pow2 in (False, True):
        card = B.train_mlp_baseline(ds, hidden, pow2=pow2, device=cuda)
        cpu = B.train_mlp_baseline(ds, hidden, pow2=pow2, device="cpu")
        assert abs(card.test_acc - cpu.test_acc) <= 0.03
        w = torch.randn(4096, device=cuda) * 0.5
        np.testing.assert_array_equal(B._pow2_ste(w).cpu().numpy(),
                                      B._pow2_ste(w.cpu()).numpy())


# ---------------------------------------------------------------------------
# The campaign layer on the card: checkpoints, campaigns, drift, workers,
# the zoo and the autopilot, each against the CPU
# ---------------------------------------------------------------------------
CAMPAIGN_BUDGET = dict(seed=0, epochs=2, cgp_points=1, cgp_iters=25,
                       pcc_samples=400)


@pytest.fixture(scope="module")
def phase_entry(tmp_path_factory):
    """The port's TINY pipeline on the CPU, cached: (root, key); campaigns
    on either device load these products by key."""
    from repro_torch.evolve import phase_cache as PCache
    from repro_torch.evolve.problems import build_tnn_problem

    root = tmp_path_factory.mktemp("phase_cache")
    build_tnn_problem("breast_cancer", device="cpu", cache_dir=str(root),
                      **CAMPAIGN_BUDGET)
    key = PCache.phase_key("breast_cancer", **CAMPAIGN_BUDGET, device="cpu")
    return str(root), key


def _campaign_spec(phase_entry, device):
    from repro_torch.evolve import ProblemSpec

    root, key = phase_entry
    return ProblemSpec("tnn", {"dataset": "breast_cancer",
                               "device": str(device), "cache_dir": root,
                               "phase_key": key, **CAMPAIGN_BUDGET})


def _run_campaign(phase_entry, device, workers=0, ckpt=None, drift=None,
                  **kw):
    from repro_torch.evolve import (Campaign, CampaignConfig,
                                    attach_tnn_drift)

    spec = _campaign_spec(phase_entry, device)
    p = spec.build()
    cfg = CampaignConfig(**{**dict(n_islands=3, pop_size=12, n_epochs=4,
                                   gens_per_epoch=3, seed=7), **kw},
                         device=str(device), workers=workers)
    with Campaign(p.domains, p.objective, cfg, checkpoint_dir=ckpt,
                  seed_population=p.seed_population,
                  problem_spec=spec) as c:
        if drift is None:
            res = c.run()
            return res.archive_x, res.archive_f, res.histories
        attach_tnn_drift(p, drift, seed=1)
        for r in range(3):
            p.drift(r)
            c.mark_drift(r)
            c.step_epoch()
        return c.archive.X, c.archive.F, [s.history for s in c.states]


def _same_run(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    state = {"w": torch.randn(8, 4, device=cuda).to(torch.bfloat16),
             "pop": torch.arange(12, device=cuda).view(3, 4),
             "F": np.linspace(0, 1, 6).reshape(3, 2)}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state, background=True)
    cm.wait()
    _, got, _ = cm.restore(state)
    assert got["w"].device == cuda and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"])
    assert torch.equal(got["pop"], state["pop"])
    assert got["F"].dtype == torch.float64
    np.testing.assert_array_equal(got["F"].cpu().numpy(), state["F"])


def test_campaign_on_card_equals_cpu(cuda, phase_entry, tmp_path):
    """The archive, serially and across two spawned workers on the card,
    and after a resume on the card from the CPU's checkpoint, equals the
    CPU's; each objective call is one launch."""
    cpu = _run_campaign(phase_entry, "cpu")
    before = CK.LAUNCHES["fused_eval_uint"]
    _same_run(_run_campaign(phase_entry, cuda), cpu)
    assert CK.LAUNCHES["fused_eval_uint"] > before
    _same_run(_run_campaign(phase_entry, cuda, workers=2), cpu)
    _run_campaign(phase_entry, "cpu", ckpt=str(tmp_path), n_epochs=2)
    _same_run(_run_campaign(phase_entry, cuda, ckpt=str(tmp_path)), cpu)


def test_drift_on_card_equals_cpu(cuda, phase_entry):
    from repro_torch.evolve import attach_tnn_drift

    card = attach_tnn_drift(_campaign_spec(phase_entry, cuda).build(), 0.25)
    cpu = attach_tnn_drift(_campaign_spec(phase_entry, "cpu").build(), 0.25)
    pop = np.random.default_rng(2).integers(
        0, card.domains[None, :], size=(24, card.domains.size))
    for r in range(3):
        card.drift(r)
        cpu.drift(r)
        got = card.objective(pop)
        np.testing.assert_array_equal(got, cpu.objective(pop))
        np.testing.assert_array_equal(
            got, np.array([card.approx._eval_one(x) for x in pop]))
    _same_run(_run_campaign(phase_entry, cuda, drift=0.5),
              _run_campaign(phase_entry, "cpu", drift=0.5))


def test_zoo_on_card_serves_through_the_megakernel(cuda, tmp_path):
    """Two spawned workers on the card train, search and emit; the zoo
    serves through the megakernel with labels equal to `predict`."""
    from repro_torch.compile import artifact as A
    from repro_torch.compile.zoo import build_zoo, make_entries
    from repro_torch.serve import ClassifierFleet

    entries = make_entries(["breast_cancer"], ["base", "lean"], islands=2,
                           pop=8, epochs=1, gens_per_epoch=2, migrate_k=1,
                           tnn_epochs=2, cgp_points=1, cgp_iters=25,
                           pcc_samples=400, device=str(cuda))
    rep = build_zoo(entries, tmp_path / "zoo", workers=2,
                    cache_dir=str(tmp_path / "cache"))
    assert len(rep["built"]) == 2
    rows = A.load_manifest(tmp_path / "zoo")
    x = np.random.default_rng(0).random((256, rows[0]["n_features"]))
    with ClassifierFleet.from_emit_dir(tmp_path / "zoo", device=cuda,
                                       megakernel=True) as fleet:
        for row in rows:
            reqs, _, _ = fleet.submit_many(row["name"], x)
            fleet.flush()
            want = A.load_program(tmp_path / "zoo" / row["program"],
                                  device=cuda).predict(x)
            np.testing.assert_array_equal([r.result(60.0) for r in reqs],
                                          want)
        assert fleet._megakernel_launches > 0 and fleet.errors == []


def test_autopilot_rounds_on_card(cuda, phase_entry, tmp_path):
    """A sabotaged candidate rolls back and a good one promotes, with the
    campaign and the fleet on the card."""
    from repro_torch.autopilot import (Autopilot, AutopilotConfig,
                                       CampaignSource, DecisionJournal,
                                       PromotionPolicy, dataset_traffic)
    from repro_torch.compile import write_artifacts
    from repro_torch.evolve import (Campaign, CampaignConfig,
                                    compile_archive_winner)
    from repro_torch.serve import ClassifierFleet

    p = _campaign_spec(phase_entry, cuda).build()
    emit = tmp_path / "fleet"
    write_artifacts(compile_archive_winner(p, p.seed_population[0]), emit,
                    base="tnn_breast_cancer", dataset="breast_cancer")
    cfg = CampaignConfig(n_islands=2, pop_size=8, n_epochs=2,
                         gens_per_epoch=2, device=str(cuda))
    campaign = Campaign(p.domains, p.objective, cfg,
                        checkpoint_dir=str(tmp_path / "ck"),
                        seed_population=p.seed_population)
    source = CampaignSource(p, campaign, require_improvement=False)
    with ClassifierFleet.from_emit_dir(emit, device=cuda) as fleet:
        pilot = Autopilot(
            fleet, source, dataset_traffic("breast_cancer"),
            DecisionJournal(emit / "journal.jsonl"),
            AutopilotConfig(tenant="tnn_breast_cancer", rounds=2,
                            mirror_pairs=64, sabotage_rounds=frozenset({0}),
                            policy=PromotionPolicy(min_pairs=32,
                                                   min_truth=16)))
        outcomes = pilot.run()
        assert [o["event"] for o in outcomes] == ["rolled_back", "promoted"]
        assert fleet.errors == []


# ---------------------------------------------------------------------------
# LM training: the WKV-6 backward kernel, autograd, one train step
# ---------------------------------------------------------------------------
def _bwd_reverse(args, dy, ds, fn):
    """The float64 forward (checkpoints) and reverse recurrence of `fn`
    applied to every operand (identity, or abs for the envelope)."""
    r = args[0]
    B, T, H, dh = r.shape
    xs = [None if a is None else fn(a.double()) for a in args]
    ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh),
                     dtype=torch.float64, device=r.device)
    WKV.rwkv6_scan_plain(*xs, ckpt=ck)
    return WKV.rwkv6_scan_bwd_plain(*xs[:5], ck, fn(dy.double()),
                                    None if ds is None else fn(ds.double()))


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H,dh", [(2, 256, 8, 64), (3, 13, 5, 64),
                                      (4, 33, 4, 16), (1, 1, 2, 16)])
def test_rwkv6_scan_bwd_kernel_inside_f32_envelope(cuda, B, T, H, dh, dtype,
                                                   state):
    """The backward kernel, from its forward instance's checkpoints, on
    the model's strided views (decays down to 1e-12), with and without s0
    and a state gradient: every gradient inside eps (dh + 2T + 4) times
    the reverse recurrence on absolute values, plus one bf16 rounding of
    dr, dk, dv; two launches bit-identical."""
    rng = np.random.default_rng(B * T + dh)
    args = _model_layout(cuda, rng, B, T, H, dh, dtype, int(state))
    s0 = ds = None
    if state:
        s0, ds = (torch.from_numpy(rng.standard_normal((B, H, dh, dh))
                                   .astype(np.float32)).to(cuda)
                  for _ in range(2))
    dy = torch.from_numpy(rng.standard_normal((B, T, H, dh))
                          .astype(np.float32)).to(cuda)
    ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh), device=cuda)
    CW.launch(*args, s0, ckpt=ck)
    before = CW.LAUNCHES["rwkv6_scan_bwd"]
    got = CW.launch_bwd(*args, ck, dy, ds)
    again = CW.launch_bwd(*args, ck, dy, ds)
    assert CW.LAUNCHES["rwkv6_scan_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exact = _bwd_reverse((*args, s0), dy, ds, lambda a: a)
    env = _bwd_reverse((*args, s0), dy, ds, torch.abs)
    gamma = float(np.finfo(np.float32).eps) * (dh + 2 * T + 4)
    for g, e, m in zip(got, exact, env):
        bound = gamma * m
        if g.dtype == torch.bfloat16:
            bound = bound * (1 + 2.0 ** -8) + 2.0 ** -8 * e.abs()
        assert ((g.double() - e).abs() <= bound).all()


def test_rwkv6_scan_under_autograd_launches_the_backward_kernel(cuda):
    rng = np.random.default_rng(3)
    r, k, v, w, u = (a.detach().clone().requires_grad_() for a in
                     _model_layout(cuda, rng, 2, 40, 3, 64, torch.bfloat16))
    CW.reset_launches()
    y, _ = WKV.rwkv6_scan(r, k, v, w, u)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y.sum(), (r, k, v, w, u))
    assert CW.LAUNCHES == {"rwkv6_scan": 1, "rwkv6_scan_bwd": 1}
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert grads[0].dtype == torch.bfloat16 and grads[4].shape == (3, 64)


def test_ternary_matmul_refuses_autograd(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w2 = torch.zeros(16, 8, dtype=torch.int8, device=cuda)
    sc = torch.ones(1, 8, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        TM.ternary_matmul(x, w2, sc)
    with torch.no_grad():
        assert TM.ternary_matmul(x, w2, sc).shape == (4, 8)


@pytest.mark.parametrize("arch,quant", [("rwkv6-7b", "dense"),
                                        ("llama3.2-1b", "ternary")])
def test_one_train_step_on_the_card_equals_the_cpu(cuda, arch, quant):
    """One train step card against CPU in float32 from the same weights
    and stream: loss within 1e-4, gradients within 1e-3 of the largest
    (f32 sums in another order), the WKV kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import grads_of

    cfg = get_config(arch).reduced().replace(quant=quant, remat=True)
    p_cpu = init_params(cfg, 0, "cpu")
    p_card = tree_map(lambda a: a.to(cuda), p_cpu)
    pcfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    b_cpu = TokenPipeline(pcfg, device="cpu").batch_at(2)
    b_card = TokenPipeline(pcfg, device=cuda).batch_at(2)
    assert all(torch.equal(b_cpu[n], b_card[n].cpu()) for n in b_cpu)
    CW.reset_launches()
    g_card, m_card = grads_of(cfg, p_card, b_card)
    g_cpu, m_cpu = grads_of(cfg, p_cpu, b_cpu)
    if arch == "rwkv6-7b":          # forward and remat recompute, backward
        assert CW.LAUNCHES == {"rwkv6_scan": 2 * cfg.n_layers,
                               "rwkv6_scan_bwd": cfg.n_layers}
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-4
    gmax = max(float(g.abs().max()) for g in tree_leaves(g_cpu))
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * gmax
