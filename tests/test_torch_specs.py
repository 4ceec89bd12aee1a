"""`repro_torch.launch.specs` against `repro.launch.specs`, leaf for leaf.

For all ten archs x the four dry-run shapes, the port's meta tensors have
the shapes and dtypes of the reference's `ShapeDtypeStruct`s (built on a
one-device mesh with `jax.eval_shape`): the train batch, the prefill
batch, the decode inputs (cache, tokens, pos and M-RoPE positions), and
for both optimizers (AdamW, 8-bit AdamW) the parameter and optimizer
state trees.  `SHAPES` and `shape_applicable`'s skip reasons equal the
reference's.  Nothing is allocated: every port leaf is on `meta`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import shape_applicable as ref_applicable  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, SHAPES, get_config, shape_applicable,
)
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402


def flat(tree, path=()):
    """`[(path, shape, dtype name)]` of a tree of dicts, tuples and
    tensor-likes (torch or JAX)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                flat(tree[k], path + (k,))]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        return [leaf for n, v in zip(names, tree) for leaf in
                flat(v, path + (n,))]
    name = str(tree.dtype).replace("torch.", "")
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", path
    return [(path, tuple(tree.shape), name)]


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_equal_reference(arch, shape, mesh):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert shape_applicable(cfg, sh) == ref_applicable(rcfg, rsh)
    assert cfg.sub_quadratic == rcfg.sub_quadratic
    for labels in (True, False):
        port = SP.train_batch_specs(cfg, sh, with_labels=labels)
        ref, _ = RSP.train_batch_specs(rcfg, rsh, mesh, with_labels=labels)
        assert flat(port) == flat(ref)
    if sh.kind == "decode":
        port = SP.decode_inputs(cfg, sh)
        ref, _ = RSP.decode_inputs(rcfg, rsh, mesh)
        assert flat(port) == flat(ref)


@pytest.mark.parametrize("opt_8bit", [False, True], ids=["adamw", "adamw8bit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_equals_reference(arch, opt_8bit, mesh):
    cfg = get_config(arch).replace(opt_8bit=opt_8bit)
    rcfg = ref_get_config(arch).replace(opt_8bit=opt_8bit)
    params, opt = SP.abstract_state(cfg)
    rparams, _, ropt, _ = RSP.abstract_state(rcfg, mesh)
    assert flat(params) == flat(rparams)
    assert flat(opt) == flat(ropt)
    n = sum(int(np.prod(s)) for _, s, _ in flat(params))
    assert n == param_count(cfg)
