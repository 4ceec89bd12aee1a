"""The port's LM training objective against the reference's, on the CPU.

`models.transformer.loss_fn` (the mean label NLL from `chunked_ce_loss`
plus `MOE_AUX_COEF` times the MoE aux loss `forward` carries) and its
gradient with respect to every parameter leaf, for each of the ten
reduced archs, against `jax.value_and_grad(repro.models.transformer.
loss_fn)` on the same numpy weights (`tests/torch_lm_reference.py`) and
the same batch, labels partly masked (-1).  The counterpart of
`tests/test_models_smoke.py::test_forward_and_grad`, with values held.

Tolerances (float32 on both sides, the same formulas, sums in another
order): the loss and the MoE aux within `LOSS_TOL = 1e-5`; every
gradient element within `GRAD_TOL = 5e-5` times the largest gradient
element of the model (measured: at most 1.2e-5, rwkv6-7b's WKV path and
hymba's Mamba loop against their scans).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import (cfgs, numpy_batch, numpy_tree,  # noqa: E402
                                ref_params, to_port, to_ref)

LOSS_TOL = 1e-5
GRAD_TOL = 5e-5


def value_and_grads(arch: str, quant: str = "dense", B: int = 2,
                    S: int = 16, **over):
    """Loss, metrics and gradients of both frameworks: port tensors and
    reference arrays, leaves in the same (sorted-key) order."""
    cfg, rcfg = cfgs(arch, quant, **over)
    tree = numpy_tree(cfg, seed=1)
    batch = numpy_batch(cfg, B, S, seed=2)
    batch["labels"] = np.random.default_rng(3).integers(-1, cfg.vocab,
                                                        (B, S))
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: RTF.loss_fn(rcfg, p, to_ref(batch)), has_aux=True)(
        ref_params(tree))
    tp = P.tree_map(lambda a: a.requires_grad_(),
                    P.params_from_reference(tree, device="cpu"))
    loss, met = TF.loss_fn(cfg, tp, to_port(batch))
    leaves = [t for _, t in P.leaves(tp)]
    grads = torch.autograd.grad(loss, leaves)
    return (loss, met, grads), (rloss, rmet, jax.tree.leaves(rgrads)), \
        [path for path, _ in P.leaves(tp)]


def check(port, ref):
    (loss, met, grads), (rloss, rmet, rgrads) = port, ref
    assert abs(float(loss.detach()) - float(rloss)) <= LOSS_TOL
    for k in ("nll", "tokens", "moe_aux"):
        assert abs(float(met[k].detach()) - float(rmet[k])) <= \
            LOSS_TOL * max(1.0, abs(float(rmet[k]))), k
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in rgrads)
    assert gmax > 0
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=0,
                                   atol=GRAD_TOL * gmax)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    port, ref, paths = value_and_grads(arch)
    assert len(port[2]) == len(ref[2]) == len(paths)
    check(port, ref)
    if arch in ("mixtral-8x22b", "arctic-480b"):     # the MoE aux is carried
        assert float(port[1]["moe_aux"].detach()) > 0


def test_ternary_qat_loss_and_grads_match_reference():
    """llama under `quant="ternary"`: the straight-through quantizer's
    forward value and its identity gradient, as `ternary_ste_lm`."""
    port, ref, _ = value_and_grads("llama3.2-1b", "ternary")
    check(port, ref)
