"""The training head and cross-entropy (`kernels/cuda_ce_head.py`,
`csrc/ce_head.cu`).

On the CPU:
* `split3` splits f32 values into three bf16 terms whose f32 sum is the
  value, bit for bit, over `p - onehot` gradients and values near 0, near
  +-1 and tiny;
* `plan` sends bf16 CUDA calls with a row-major `(K, V)` head to `fused`
  and f32, the CPU, an unaligned K or V, a tied table and a bias to
  `plain`; its chunk and split arithmetic;
* the loss's plain route (`_ce_chunk` chunk by chunk, every CPU call)
  matches the JAX reference's `chunked_ce_loss` in value, dX and dW, tied
  and untied, with masked labels and chunk counts that do not divide S,
  within `TOL` (float32 sums in another order);
* `CEHead` and its place in `chunked_ce_loss` (the fused route forced,
  each kernel's step stood in for by a float64 emulation of its
  arithmetic: logZ, D in f32 split by `split3`, dX and dW summed over the
  three planes) give what the plain route gives, count each route and
  keep the forward in the `model.loss` span.

On the card (`cuda`-marked, skipped without a CUDA device):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ce_head.py

loss, dX and dW at rwkv6-7b's width (K 4,096, V 65,536) at its training
microbatch's 8,192 rows and at a ragged 1,400, each within twice the f32
path's error against float64 (dX and dW compared in bf16, the dtype both
return); two launches bit-identical; a training step routes every loss
call `fused`, `LAUNCHES["ce_head"]` counts each kernel the wrapper
launches (2 a forward, 3 a chunk of the backward), and every kernel
launch lies inside the `model.loss` and `model.loss.backward` spans.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace as TR  # noqa: E402
from repro_torch.kernels import cuda_ce_head as CH  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32
RWKV_K, RWKV_V = 4096, 65536


def _plan(x_shape=(2, 4096, RWKV_K), w_shape=(RWKV_K, RWKV_V), *,
          dtypes=(BF16, BF16), device_type="cuda", row_major=True,
          bias=False):
    return CH.plan(x_shape, w_shape, dtypes=dtypes, device_type=device_type,
                   row_major=row_major, bias=bias)


def _gradients(n: int, rng) -> np.ndarray:
    """n rows of `g (softmax(z) - onehot)` over 64 columns, z spread wide."""
    z = rng.normal(0, 8, (n, 64))
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    p[np.arange(n), rng.integers(0, 64, n)] -= 1.0
    return p / 8192.0


@pytest.mark.parametrize("kind", ["p_minus_onehot", "near_zero",
                                  "near_one", "near_minus_one", "tiny",
                                  "wide"])
def test_split3_recombines_exactly(kind):
    rng = np.random.default_rng(7)
    n = 4096
    d = {"p_minus_onehot": lambda: _gradients(64, rng).ravel(),
         "near_zero": lambda: rng.normal(0, 1e-6, n),
         "near_one": lambda: 1.0 + rng.normal(0, 1e-4, n),
         "near_minus_one": lambda: -1.0 + rng.normal(0, 1e-4, n),
         "tiny": lambda: rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-32, -20, n),
         "wide": lambda: rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-32, 32, n)}[kind]
    x = torch.from_numpy(np.append(d(), [0.0, -0.0])).float()
    assert bool((x.abs() >= 2.0 ** -110).sum() == len(x) - 2)
    hi, mid, lo = CH.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == BF16
    assert torch.equal(hi, x.to(BF16))
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 4096, RWKV_K), (RWKV_K, RWKV_V)),     # rwkv6-7b's microbatch
    ((3, 467, RWKV_K), (RWKV_K, RWKV_V)),      # ragged rows
    ((2, 32, 64), (64, 128)),                  # the tiny training cell
    ((1400, 4096), (4096, 152064)),            # qwen2.5's vocabulary
])
def test_plan_routes_to_fused(x_shape, w_shape):
    p = _plan(x_shape, w_shape)
    assert p.route == "fused" and p.why == ""
    M = int(np.prod(x_shape[:-1]))
    assert p.chunk_rows % CH.BLOCK_M == 0 and p.chunk_rows >= 1
    assert 1 <= p.splits <= -(-w_shape[1] // CH.BLOCK_N)
    assert 1 <= p.grad_splits <= -(-w_shape[1] // CH.BLOCK_N)
    assert -(-M // p.chunk_rows) * p.chunk_rows >= M


@pytest.mark.parametrize("kw,why", [
    (dict(dtypes=(F32, F32)), "bf16"),
    (dict(dtypes=(BF16, F32)), "bf16"),
    (dict(device_type="cpu"), "cpu"),
    (dict(device_type="meta"), "meta"),
    (dict(x_shape=(2, 8, 100), w_shape=(100, 128)), "multiple of 64"),
    (dict(x_shape=(2, 8, 64), w_shape=(64, 1001)), "of 8"),
    (dict(row_major=False), "tied"),
    (dict(bias=True), "bias"),
    (dict(x_shape=(2, 8, 64), w_shape=(128, 64)), "head"),
])
def test_plan_routes_to_plain(kw, why):
    p = _plan(**kw)
    assert p.route == "plain" and why in p.why


@pytest.mark.parametrize("M,K,rows", [
    (8192, 4096, 2048),      # rwkv6-7b's microbatch: 4 chunks
    (1400, 4096, 1408),      # one ragged chunk
    (16384, 5120, 3328),     # 5 chunks under qwen2.5's 3,413-row cap
    (64, 64, 128),           # the floor of one block
])
def test_chunk_rows(M, K, rows):
    assert CH.chunk_rows(M, K) == rows
    # each chunk's three bf16 planes take no more than the f32 head copy
    # the plain path makes (4 K bytes a column), save the one-block floor
    assert 6 * rows <= 4 * K or rows == CH.BLOCK_M


def test_v_splits_fill_the_card():
    assert CH.v_splits(8192, RWKV_V) == 4       # 64 row blocks: 256 CTAs
    assert CH.v_splits(2048, RWKV_V) == 16      # 16 row blocks: 256 CTAs
    assert CH.v_splits(1400, RWKV_V) == 24      # 11 row blocks: 264 CTAs
    assert CH.v_splits(128, RWKV_V) == 256      # 1 row block: a tile each
    assert CH.v_splits(64, 128) == 1            # one tile of V
    assert CH.v_splits(10 ** 6, RWKV_V) == 1


def _head_case(S: int, tied: bool, seed: int):
    from torch_lm_reference import cfgs, numpy_tree

    cfg, rcfg = cfgs("llama3.2-1b", "dense", tie_embeddings=tied)
    tree = numpy_tree(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, S))
    labels[0, :3] = -1                                 # masked
    return cfg, rcfg, tree, x, labels


@pytest.mark.parametrize("S,tied,n_chunks", [
    (13, False, 8),           # 8 lowered to 1: S prime
    (12, True, 8),            # 8 lowered to 6 chunks of 2
    (7, False, 1),            # one chunk, S not a multiple of any tile
    (16, True, 5)])           # 5 lowered to 4 chunks of 4
def test_function_plain_matches_reference(S, tied, n_chunks):
    """The loss's plain route, `chunked_ce_loss` on CPU tensors, against
    the JAX reference's `chunked_ce_loss`: the NLL, dX and dW."""
    jax = pytest.importorskip("jax")
    from repro.models import transformer as RTF
    from test_torch_transformer import ref_params

    cfg, rcfg, tree, x, labels = _head_case(S, tied, seed=S + tied)
    rp = ref_params(tree)

    def ref_nll(xj, wj):
        if tied:
            p = {**rp, "embed": {**rp["embed"], "tokens": wj}}
        else:
            p = {**rp, "lm_head": {**rp["lm_head"], "w": wj}}
        return RTF.chunked_ce_loss(rcfg, p, xj, jax.numpy.asarray(
            labels, jax.numpy.int32), n_chunks)[0]

    w_ref = rp["embed"]["tokens"] if tied else rp["lm_head"]["w"]
    rn, (rgx, rgw) = jax.value_and_grad(ref_nll, argnums=(0, 1))(
        jax.numpy.asarray(x), w_ref)

    tp = P.params_from_reference(tree, "cpu")
    w = (tp["embed"]["tokens"] if tied else tp["lm_head"]["w"]) \
        .requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    CH.reset_launches()
    n, t = TF.chunked_ce_loss(cfg, tp, xt, torch.from_numpy(labels),
                              n_chunks)
    assert CH.VARIANT_LAUNCHES == {"fused": 0, "plain": 1}
    gx, gw = torch.autograd.grad(n, [xt, w])
    assert float(t) == float((labels >= 0).sum())
    assert abs(float(n.detach()) - float(rn)) <= TOL * abs(float(rn))
    for got, want in ((gx, rgx), (gw, rgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())


def _lse_emulated(x, w, labels, p):
    """`ce_lse`'s arithmetic in float64: each row's logZ and NLL, f32."""
    z = x.double() @ w.double()
    logz = torch.logsumexp(z, -1)
    ll = torch.gather(z, 1, labels.clamp(min=0).long()[:, None])[:, 0]
    return logz.float(), torch.where(labels >= 0, logz - ll, 0.0).float()


def _grads_emulated(x, w, labels, logz, g, p):
    """`ce_grad`, `ce_dx` and `ce_dw`'s arithmetic: D in f32 as three bf16
    planes (`split3`), dX and dW the float64 sums of the planes'
    products, rounded once to x's and w's dtypes."""
    z = x.double() @ w.double()
    gm = g.double() * (labels >= 0).double()[:, None]
    d = gm * (torch.exp(z - logz.double()[:, None])
              - torch.nn.functional.one_hot(labels.clamp(min=0).long(),
                                            w.shape[1]).double())
    planes = [t.double() for t in CH.split3(d.float())]
    dx = sum(pl @ w.double().T for pl in planes)
    dw = sum(x.double().T @ pl for pl in planes)
    return dx.to(x.dtype), dw.to(w.dtype)


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_ce_loss_on_the_fused_route(monkeypatch, tied):
    """`chunked_ce_loss` routed `fused` (forced here, each kernel's step
    emulated: the kernels run on the card only) gives its plain route's
    NLL, count and gradients within `TOL`, counts each route and no
    kernel launch, and keeps the forward in the `model.loss` span."""
    from torch_lm_reference import cfgs, numpy_tree

    cfg, _ = cfgs("llama3.2-1b", "dense", tie_embeddings=tied)
    tree = numpy_tree(cfg, seed=3)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 12, cfg.d_model))
                         .astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, cfg.vocab, (2, 12)))
    out = {}
    for route in ("plain", "fused"):
        if route == "fused":
            monkeypatch.setattr(CH, "route", lambda *a, **k: CH.Plan(
                "fused", "", 1, 8, 1))
            monkeypatch.setattr(CH, "lse", _lse_emulated)
            monkeypatch.setattr(CH, "grads", _grads_emulated)
        CH.reset_launches()
        tp = P.tree_map(lambda a: a.requires_grad_(),
                        P.params_from_reference(tree, "cpu"))
        xr = x.clone().requires_grad_()
        TR.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            n, t = TF.chunked_ce_loss(cfg, tp, xr, labels)
        leaves = [xr] + [a for _, a in P.leaves(tp)]
        out[route] = (n.detach(), t, torch.autograd.grad(
            n, leaves, allow_unused=True))
        assert CH.LAUNCHES["ce_head"] == 0
        assert CH.VARIANT_LAUNCHES == {"plain": int(route == "plain"),
                                       "fused": int(route == "fused")}
        assert [s.name for s in TR.spans()] == ["model.loss"]
        TR.clear()
    (n0, t0, g0), (n1, t1, g1) = out["plain"], out["fused"]
    assert float(t0) == float(t1)
    assert abs(float(n1) - float(n0)) <= TOL * abs(float(n0))
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=TOL,
                                       atol=TOL * float(a.abs().max()))


def test_plain_route_unchanged_on_the_cpu():
    """On CPU tensors `chunked_ce_loss` keeps its chunk loop: the plain
    route, counted."""
    from torch_lm_reference import cfgs, numpy_tree

    cfg, _ = cfgs("llama3.2-1b", "dense")
    tp = P.params_from_reference(numpy_tree(cfg), "cpu")
    CH.reset_launches()
    TF.chunked_ce_loss(cfg, tp, torch.randn(2, 8, cfg.d_model),
                       torch.zeros((2, 8), dtype=torch.long))
    assert CH.VARIANT_LAUNCHES == {"fused": 0, "plain": 1}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, M: int, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, RWKV_K, device=dev, generator=gen).to(BF16)
    w = (torch.randn(RWKV_K, RWKV_V, device=dev, generator=gen)
         * (2.0 / RWKV_K ** 0.5)).to(BF16)
    labels = torch.randint(0, RWKV_V, (M,), device=dev, generator=gen)
    labels[torch.rand(M, device=dev, generator=gen) < 0.1] = -1
    return x, w, labels


def _reference(x, w, labels, dtype):
    """The loss (the NLL over its count) and its gradients, rounded to x's
    and w's dtype, computed in `dtype`."""
    xr = x.to(dtype).requires_grad_()
    wr = w.to(dtype).requires_grad_()
    z = xr @ wr
    keep = labels >= 0
    ll = torch.gather(z, 1, labels.clamp(min=0)[:, None])[:, 0]
    nll = ((torch.logsumexp(z, -1) - ll) * keep).sum()
    loss = nll / keep.sum()
    gx, gw = torch.autograd.grad(loss, [xr, wr])
    return nll.detach(), gx, gw


def _fused(x, w, labels):
    p = CH.route(x, w)
    assert p.route == "fused", p.why
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    nll, cnt = CH.ce_head(xr, wr, labels, p)
    gx, gw = torch.autograd.grad(nll / cnt, [xr, wr])
    return nll.detach(), gx, gw


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8192, 1400])
def test_card_matches_float64(dev, M):
    x, w, labels = _card_case(dev, M)
    got = _fused(x, w, labels)
    assert got[1].dtype == got[2].dtype == BF16
    f32 = _reference(x, w, labels, F32)
    f64 = _reference(x, w, labels, torch.float64)
    # the tensor cores' f32 sums round toward zero: the NLL reads lower than
    # float64's by ~1.25e-6 of itself on an H100 SXM, within TOL
    n64 = float(f64[0])
    assert abs(float(got[0]) - n64) <= TOL * abs(n64)
    for k, name in ((1, "dX"), (2, "dW")):
        err = float((got[k].double() - f64[k]).abs().max())
        ref = float((f32[k].to(BF16).double() - f64[k]).abs().max())
        assert err <= 2 * ref, f"{name}: {err} against the f32 path's {ref}"


@pytest.mark.cuda
def test_card_two_launches_bit_identical(dev):
    x, w, labels = _card_case(dev, 1400, seed=1)
    a, b = _fused(x, w, labels), _fused(x, w, labels)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_card_train_step_fused_inside_the_loss_spans(dev, monkeypatch):
    """The tiny training cell on the card: every loss call of a step takes
    the `fused` route, and every kernel launch (its host call, on the
    spans' clock) lies inside `model.loss` (the forward's) or
    `model.loss.backward` (the backward's)."""
    from bench.drivers import train_steps
    from bench.tests import tiny

    ctx = dataclasses.replace(tiny.train_ctx(), device=dev)
    prog = train_steps.Training(ctx)
    lib, calls = CH._lib(), []

    class Recording:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*a):
                calls.append((name, time.time_ns()))
                return fn(*a)
            return call

    monkeypatch.setattr(CH, "_lib", Recording)
    prog.step()                                   # warm-up
    torch.cuda.synchronize()
    CH.reset_launches()
    calls.clear()
    TR.clear()
    steps, n_mb = 2, ctx.mix["microbatches"]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(steps):
            prog.step()
        torch.cuda.synchronize()
    assert CH.VARIANT_LAUNCHES == {"fused": steps * n_mb, "plain": 0}
    spans = {name: [(s.start_ns, s.end_ns) for s in TR.spans()
                    if s.name == name]
             for name in ("model.loss", "model.loss.backward")}
    TR.clear()
    names = [n for n, _ in calls]
    assert names.count("ce_lse") == steps * n_mb
    chunks = names.count("ce_grad")
    assert chunks >= steps * n_mb
    assert names.count("ce_dx") == names.count("ce_dw") == chunks
    assert CH.LAUNCHES["ce_head"] == 2 * steps * n_mb + 3 * chunks
    for name, t in calls:
        where = "model.loss" if name == "ce_lse" else "model.loss.backward"
        assert any(a <= t <= b for a, b in spans[where]), (name, where)
