"""Every reference arch in the port: configs, parameter trees, the Qwen
dense archs against the reference, and what runs the ternary matmul.

* `get_config` equals the reference's field for field for all ten archs,
  full and reduced; `param_count` and `active_param_count` are equal at
  full size under each quant the arch takes.
* The reduced trees of the eight archs this slice added: the same leaf
  paths, shapes and dtypes as the reference's `init_params`.
* qwen2-1.5b (QKV bias, tied embeddings), qwen3-4b (qk-norm, a decoupled
  head_dim) and qwen2.5-14b (untied head) through
  `torch_lm_reference.check_model`, dense and ternary_packed, within
  `ATOL` (1e-4).
* `serving_params` and `quantize_params` pack exactly the projections
  `_lin` defines: the MoE router and experts and Mamba's conv and state
  leaves stay plain, whisper's encoder projections are packed; the
  ternary matmul is given exactly the `(K, N)` of `lin_shapes`.
* `launch.families.FAMILIES` serves every arch but RWKV-6 at its
  published width, cut only in depth.
* Under ternary_packed, the ternary matmul runs per layer and forward: 7
  times for the dense and Qwen archs, arctic and qwen2-vl, 4 for mixtral
  (attention only: its experts are dense), none for hymba (dense only);
  whisper 6 per encoder layer plus 10 per decoder layer at prefill and 8
  per decoder layer at decode (`chip_smoke.py`'s `lm_families` counts the
  same on the card).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.families import FAMILIES  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

from torch_lm_reference import cfgs, check_model, numpy_batch, numpy_tree, to_port  # noqa: E402,E501

NEW = ["qwen2-vl-72b", "hymba-1.5b", "whisper-medium", "arctic-480b",
       "mixtral-8x22b", "qwen2-1.5b", "qwen3-4b", "qwen2.5-14b"]
DENSE_ONLY = {"hymba-1.5b", "rwkv6-7b"}


def quants(arch: str) -> list[str]:
    return ["dense"] if arch in DENSE_ONLY else ["dense", "ternary_packed"]


def test_archs_are_the_reference_archs():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_config(arch).reduced(),
                       ref_get_config(arch).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.head_dim == ref.head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    for quant in quants(arch):
        cfg = get_config(arch).replace(quant=quant)
        rcfg = ref_get_config(arch).replace(quant=quant)
        assert P.param_count(cfg) == RP.param_count(rcfg)
        assert P.active_param_count(cfg) == RP.active_param_count(rcfg)


@pytest.mark.parametrize("arch", NEW)
def test_param_tree_matches_reference_init(arch):
    for quant in quants(arch):
        cfg, rcfg = cfgs(arch, quant)
        ref = RP.init_params(jax.random.PRNGKey(0), rcfg)
        port = P.init_params(cfg, seed=0, device="cpu")
        rleaves = jax.tree_util.tree_flatten_with_path(ref)[0]
        pleaves = list(P.leaves(port))
        assert [tuple(k.key for k in path) for path, _ in rleaves] == \
            [path for path, _ in pleaves]
        for (_, r), (_, t) in zip(rleaves, pleaves):
            assert tuple(r.shape) == tuple(t.shape)
            assert str(r.dtype) == str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-4b", "qwen2.5-14b"])
@pytest.mark.parametrize("quant", ["dense", "ternary_packed"])
def test_qwen_dense_matches_reference(arch, quant):
    check_model(arch, quant)


def _lin_paths(cfg) -> set:
    """Paths of the dense `w` leaves `_lin` defines (parent of `w`)."""
    return {path[:-1] for path, d in
            P.leaves(P.param_defs(cfg.replace(quant="dense"))) if d.lin}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b",
                                  "whisper-medium", "qwen2-vl-72b"])
def test_packing_takes_exactly_the_lin_leaves(arch):
    cfg, _ = cfgs(arch, "ternary_packed")
    lin = _lin_paths(cfg)
    served = P.serving_params(cfg, seed=0, device="cpu")
    drawn = P.quantize_params(cfg, P.init_params(cfg.replace(quant="dense"),
                                                 seed=1, device="cpu"))
    defs = dict(P.leaves(P.param_defs(cfg)))
    for tree in (served, drawn):
        packed = {path[:-1] for path, _ in P.leaves(tree)
                  if path[-1] == "w2"}
        assert packed == lin
        for path, t in P.leaves(tree):
            assert tuple(t.shape) == defs[path].shape, path
            assert t.dtype == defs[path].dtype, path
        assert {(4 * t.shape[-2], t.shape[-1]) for path, t in P.leaves(tree)
                if path[-1] == "w2"} == P.lin_shapes(cfg)
    if cfg.enc_layers:
        assert ("enc_layers", "attn", "wq") in lin
    if cfg.moe is not None:
        assert not any(p[:3] == ("layers", "moe", "experts") for p in lin)


def test_seeded_codes_are_the_quantized_draw():
    """`serving_params` is the seeded dense draw of `init_params` through
    `quantize_params`, bit for bit (one alpha per layer and column), and
    its codes are the quantized draw, not the all-zero init."""
    cfg, _ = cfgs("whisper-medium", "ternary_packed")
    dense = P.init_params(cfg.replace(quant="dense"), seed=3, device="cpu")
    packed = P.serving_params(cfg, seed=3, device="cpu")
    again = P.quantize_params(cfg, dense)
    for (pa, a), (pb, b) in zip(P.leaves(again), P.leaves(packed)):
        assert pa == pb and torch.equal(a, b), pa
    for path, t in P.leaves(packed):
        if path[-1] == "w2":
            assert bool(t.any()), path


def _launches_per_layer(arch: str) -> tuple[int, int]:
    """(prefill, decode) ternary-matmul calls of one forward, counted."""
    return {"mixtral-8x22b": (4, 4), "hymba-1.5b": (0, 0)}.get(arch, (7, 7))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "rwkv6-7b"])
def test_ternary_matmul_calls_per_layer(arch, monkeypatch):
    quant = quants(arch)[-1]
    cfg, _ = cfgs(arch, quant)
    calls = []
    real = ops.ternary_matmul

    def counted(x, w2, scale):
        calls.append(x.reshape(-1, x.shape[-1]).shape[0])
        return real(x, w2, scale)

    monkeypatch.setattr(ops, "ternary_matmul", counted)
    tp = P.quantize_params(cfg, P.init_params(cfg.replace(quant="dense"),
                                              seed=0, device="cpu"))
    B, S = 2, 8
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, tp, to_port(numpy_batch(cfg, B, S, 0)),
                              16)
        n_prefill = len(calls)
        TF.decode_step(cfg, tp, cache, torch.ones((B, 1), dtype=torch.long),
                       S)
    n_decode = len(calls) - n_prefill
    L = cfg.n_layers
    if cfg.enc_layers:
        assert (n_prefill, n_decode) == (6 * cfg.enc_layers + 10 * L, 8 * L)
        assert sorted(set(calls[:n_prefill])) == [B * S, B * cfg.enc_seq]
    else:
        per = _launches_per_layer(arch)
        assert (n_prefill, n_decode) == (per[0] * L, per[1] * L)
        assert set(calls[:n_prefill]) <= {B * S}
    assert set(calls[n_prefill:]) <= {B}


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in DENSE_ONLY])
def test_projection_shapes_are_lin_shapes(arch, monkeypatch):
    """A prefill and a decode step give the ternary matmul exactly the
    `(K, N)` of `lin_shapes`, the set `chip_smoke.py`'s `lm_families`
    holds the card's served shapes to."""
    cfg, _ = cfgs(arch, "ternary_packed")
    seen = set()
    real = ops.ternary_matmul

    def recorded(x, w2, scale):
        seen.add((4 * w2.shape[0], w2.shape[1]))
        return real(x, w2, scale)

    monkeypatch.setattr(ops, "ternary_matmul", recorded)
    tp = P.serving_params(cfg, seed=0, device="cpu")
    with torch.inference_mode():
        _, cache = TF.prefill(cfg, tp, to_port(numpy_batch(cfg, 2, 8, 0)),
                              16)
        TF.decode_step(cfg, tp, cache, torch.ones((2, 1), dtype=torch.long),
                       8)
    assert seen == P.lin_shapes(cfg)


def test_families_cover_every_arch_but_rwkv():
    assert sorted(f.arch for f in FAMILIES) == sorted(
        set(ARCHS) - {"rwkv6-7b"})


@pytest.mark.parametrize("fam", FAMILIES, ids=lambda f: f.arch)
def test_family_rows_keep_published_width(fam):
    """Each row serves its arch at the published width, cut only in
    depth, under its quant and overrides."""
    full = get_config(fam.arch)
    cfg = fam.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(full.replace(
        quant=fam.quant, n_layers=fam.depth or full.n_layers,
        **dict(fam.over)))
    assert cfg.n_layers <= full.n_layers
    if fam.arch in DENSE_ONLY:
        assert fam.quant == "dense"
    assert fam.prompt_tokens <= fam.cache_len
    if cfg.frontend == "vision":
        assert fam.prompt_tokens >= cfg.n_vision_tokens
    assert fam.config(compute_dtype="float32").compute_dtype == "float32"
