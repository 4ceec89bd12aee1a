"""The pieces of the port's LM objective, on the CPU: `chunked_ce_loss`
against the reference's, the MoE aux loss `forward` carries,
`ternary_ste_lm`, remat, and the ternary matmul's refusal of autograd.

`chunked_ce_loss` and `ternary_ste_lm` compute float32 functions on the
same numbers as the reference: within `TOL = 1e-5` (sums in another
order); the straight-through gradient is the identity, exactly.  Remat
(`cfg.remat`, each layer and loss chunk run under
`torch.utils.checkpoint`) recomputes the same operations: gradients
equal to the run without it, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ternary as RT  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.core import ternary as T  # noqa: E402
from repro_torch.kernels import ternary_matmul as TM  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import cfgs, numpy_tree, ref_params  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("S,n_chunks,tied", [
    (12, 8, True),       # 8 does not divide 12: lowered to 6
    (7, 8, False),       # prime S: one chunk
    (16, 8, True), (5, 3, False)])
def test_chunked_ce_matches_reference(S, n_chunks, tied):
    cfg, rcfg = cfgs("llama3.2-1b", "dense", tie_embeddings=tied)
    tree = numpy_tree(cfg, seed=S)
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, S))
    labels[0, :3] = -1                                 # masked
    rn, rt = RTF.chunked_ce_loss(rcfg, ref_params(tree), jnp.asarray(x),
                                 jnp.asarray(labels, jnp.int32), n_chunks)
    n, t = TF.chunked_ce_loss(cfg, P.params_from_reference(tree, "cpu"),
                              torch.from_numpy(x), torch.from_numpy(labels),
                              n_chunks)
    assert float(t) == float(rt) == float((labels >= 0).sum())
    assert abs(float(n) - float(rn)) <= TOL * abs(float(rn))


def test_chunked_ce_of_all_masked_labels_is_zero():
    cfg, _ = cfgs("llama3.2-1b", "dense")
    tp = P.params_from_reference(numpy_tree(cfg), "cpu")
    x = torch.randn(2, 8, cfg.d_model)
    n, t = TF.chunked_ce_loss(cfg, tp, x, torch.full((2, 8), -1))
    assert float(n) == 0.0 and float(t) == 0.0
    loss, met = TF.loss_fn(cfg, tp, {"tokens": torch.zeros((2, 8),
                                                           dtype=torch.long),
                                     "labels": torch.full((2, 8), -1)})
    assert float(loss) == 0.0 and float(met["tokens"]) == 0.0


def test_ternary_ste_lm_value_and_gradient():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (24, 10)).astype(np.float32)
    want = RT.ternary_ste_lm(jnp.asarray(w))
    gw = torch.from_numpy(w).requires_grad_()
    got = T.ternary_ste_lm(gw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL * 0.05)
    # the value is codes * alpha up to the rounding of w + (q - w): an ulp
    # of the larger of the two
    codes, alpha = T.ternary_quantize_lm(torch.from_numpy(w))
    q = codes * alpha
    ulp = np.finfo(np.float32).eps * torch.maximum(q.abs(),
                                                   torch.from_numpy(w).abs())
    assert bool(((got.detach() - q).abs() <= ulp).all())
    cot = torch.from_numpy(rng.normal(0, 1, (24, 10)).astype(np.float32))
    g, = torch.autograd.grad((got * cot).sum(), gw)
    assert torch.equal(g, cot)              # straight through, exactly
    rg = jax.grad(lambda a: jnp.sum(RT.ternary_ste_lm(a) * cot.numpy()))(
        jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(rg), cot.numpy())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b",
                                  "mixtral-8x22b", "whisper-medium"])
def test_remat_changes_memory_only(arch):
    cfg, _ = cfgs(arch, "dense")
    tree = numpy_tree(cfg, seed=4)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))}
    if cfg.enc_layers:
        batch["enc_frames"] = torch.from_numpy(
            rng.normal(0, 0.5, (2, cfg.enc_seq, cfg.d_model))
            .astype(np.float32))
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        tp = P.tree_map(lambda a: a.requires_grad_(),
                        P.params_from_reference(tree, "cpu"))
        loss, _ = TF.loss_fn(c, tp, batch)
        out.append((loss, torch.autograd.grad(
            loss, [t for _, t in P.leaves(tp)])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_forward_carries_the_moe_aux():
    cfg, rcfg = cfgs("mixtral-8x22b", "dense")
    tree = numpy_tree(cfg, seed=2)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    with torch.inference_mode():
        h, aux, caches = TF.forward(cfg, P.params_from_reference(tree, "cpu"),
                                    {"tokens": torch.from_numpy(tokens)})
    rh, raux, _ = RTF.forward(rcfg, ref_params(tree),
                              {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert caches is None and aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(raux)) <= TOL * float(raux)
    assert TF.MOE_AUX_COEF == RTF.MOE_AUX_COEF
    dense, _ = cfgs("llama3.2-1b", "dense")
    with torch.inference_mode():
        _, aux0, _ = TF.forward(dense, P.params_from_reference(
            numpy_tree(dense), "cpu"), {"tokens": torch.from_numpy(tokens)})
    assert float(aux0) == 0.0


def test_ternary_matmul_refuses_autograd_on_cuda_only(monkeypatch):
    """On the CPU the plain version is differentiable; on a CUDA tensor
    the router refuses before any launch when autograd records (the card
    test holds the refusal itself)."""
    x = torch.randn(3, 8, requires_grad=True)
    w2 = torch.zeros(2, 4, dtype=torch.int8)
    y = TM.ternary_matmul(x, w2, torch.ones(1, 4))
    assert y.requires_grad
    import inspect
    src = inspect.getsource(TM.ternary_matmul)
    assert "torch.is_grad_enabled()" in src and "no backward" in src
