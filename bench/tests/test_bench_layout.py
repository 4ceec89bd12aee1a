"""What the harness reads for its configurations stays as recorded
(`recorded.json`) while each architecture's layout, reference and model
FLOPs come from its reference module: the leaves of both configurations
in order, path, shape, dtype and init; hashes of every leaf drawn at the
tiny size; the parameter counts; and `mfu.serve`, `mfu.train`,
`ternary_mm_roofline` and the WKV rooflines read on recorded runs of the
three cells' shapes.  Beside them, what a new architecture relies on:
the module chosen by a configuration's `reference` key, leaves in some
layers only, nested spec classes, windowed attention pairs and a clear
error for a training cell whose module has no loss."""
import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from bench import gen, harness, reference, roofline, weights
from bench.drivers import flat, model_config, serve_calls, train_steps
from bench.tests import tiny

RECORDED = json.loads((Path(__file__).parent / "recorded.json").read_text())
CONFIGS = ["rwkv6-7b", "qwen2.5-14b-ternary"]


def config(name: str) -> dict:
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_as_recorded(name):
    got = [[".".join(lf.path), list(lf.shape), str(lf.dtype).split(".")[-1],
            list(lf.init), lf.stacked] for lf in weights.leaves(config(name))]
    assert got == RECORDED["leaves"][name]
    assert all(lf.layers is None for lf in weights.leaves(config(name)))


@pytest.mark.parametrize("name", CONFIGS)
def test_param_counts_are_as_recorded(name):
    for L, want in RECORDED["param_counts"][name].items():
        assert weights.param_counts(config(name), int(L)) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_draws_are_as_recorded(name):
    cfg = tiny.config(name)
    tree = weights.draw(cfg, RECORDED["seed"], "cpu", cfg["model"]["n_layers"])
    got = {k: hashlib.sha256(v.contiguous().view(torch.uint8).numpy()
                             .tobytes()).hexdigest()[:16]
           for k, v in flat(tree).items()}
    assert got == RECORDED["draws"][name]


class Kernels:
    """A trace that reads `seconds` for any kernel names."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def kernel_seconds(self, names):
        return self.seconds, 1


def recorded_run(rec: dict) -> harness.Run:
    """A run of the recorded cell: `cycles` whole cycles of its calls, or
    `steps` training steps, in `window_s` seconds."""
    spec, cfg, mix = harness.cell_files(rec["cell"])
    if "cycles" in rec:
        reqs, grp = [], []
        for c in range(rec["cycles"]):
            for ci, call in enumerate(gen.call_layout(mix)):
                reqs += [[p, nt, nt, 1.25 + 0.01 * ci + 0.001 * c]
                         for p, nt in call]
                grp += serve_calls.groups(mix, gen.Call(
                    tuple([0] * p for p, _ in call),
                    tuple(nt for _, nt in call)))
        work = {"requests": reqs, "groups": grp}
    else:
        work = {"steps": rec["steps"],
                "tokens": rec["steps"] * mix["batch"] * mix["seq_len"],
                "layers": cfg["model"]["n_layers"] // mix["pipeline_stages"]}
    return harness.Run(cfg, mix, window_s=rec["window_s"], work=work,
                       trace=Kernels(rec["kernel_s"]))


@pytest.mark.parametrize("cell,metric", [
    (r["cell"], m) for r in RECORDED["runs"] for m in r["readings"]])
def test_readings_are_as_recorded(cell, metric):
    rec, = [r for r in RECORDED["runs"] if r["cell"] == cell]
    assert harness.reader(metric)(recorded_run(rec)) == rec["readings"][metric]


def test_the_module_is_the_default_or_the_named_one():
    assert reference.name(config("rwkv6-7b")) == "rwkv6"
    assert reference.name(config("qwen2.5-14b-ternary")) == "qwen2"
    named = dict(config("qwen2.5-14b-ternary"), reference="rwkv6")
    assert reference.module(named).__name__ == "bench.reference.rwkv6"


@pytest.fixture
def some_layers(monkeypatch):
    """A configuration whose module has a leaf in layers 1 and 3 only."""
    mod = types.ModuleType("bench.reference.some_layers")

    def leaves(model):
        dt = weights.DTYPES[model["param_dtype"]]
        return weights.base_leaves(model) + [
            weights.Leaf(("layers", "dense", "w"), (model["d_model"], 8), dt,
                         ("normal", 0.5), True, layers=(1, 3))]

    mod.leaves = leaves
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    cfg = tiny.config("qwen2.5-14b-ternary")
    cfg["model"]["n_layers"] = 4
    return dict(cfg, reference="some_layers")


def test_a_leaf_in_some_layers_is_stacked_over_those(some_layers):
    cfg = some_layers
    (leaf,) = [lf for lf in weights.leaves(cfg) if lf.layers]
    tree = weights.draw(cfg, 7, "cpu", 4)
    stack = tree["layers"]["dense"]["w"]
    assert stack.shape[0] == 2
    for j, i in enumerate((1, 3)):
        assert torch.equal(stack[j], weights.draw_leaf(leaf, 7, "cpu", i))
        assert torch.equal(weights.draw_layer(cfg, 7, "cpu", i)["dense"]["w"],
                           stack[j])
    assert "dense" not in weights.draw_layer(cfg, 7, "cpu", 2)
    assert "dense" not in weights.draw(cfg, 7, "cpu", 1)["layers"]
    # two norms a layer, the dense leaf where it exists, the final norm
    D = cfg["model"]["d_model"]
    assert weights.param_counts(cfg, 4)["layers"] == \
        4 * 2 * D + 2 * D * 8 + D
    assert weights.param_counts(cfg, 2)["layers"] == \
        2 * 2 * D + 1 * D * 8 + D


def test_nested_specs_are_built_and_arrays_are_tuples():
    from repro_torch.configs.base import MoESpec, SSMSpec
    model = dict(config("qwen2.5-14b-ternary")["model"], family="moe",
                 moe={"n_experts": 8, "top_k": 2}, mrope_sections=[2, 3, 3])
    cfg = model_config(model, 4)
    assert cfg.moe == MoESpec(n_experts=8, top_k=2)
    assert cfg.mrope_sections == (2, 3, 3)
    hash(cfg)
    rwkv = model_config(config("rwkv6-7b")["model"], 4)
    assert isinstance(rwkv.ssm, SSMSpec) and rwkv.n_layers == 4


@pytest.mark.parametrize("S,window", [(1, None), (7, None), (7, 3), (9, 1),
                                      (5, 5), (4, 9), (2048, 1024)])
def test_attention_pairs_are_the_masks(S, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    seen = k <= q
    if window is not None:
        seen &= q - k < window
    assert roofline.attention_pairs(S, window) == int(seen.sum())
    assert roofline.attention_flops(S, 3, 4, window) == \
        4.0 * 3 * 4 * int(seen.sum())


def test_a_training_cell_without_a_loss_fails_at_setup():
    ctx = tiny.train_ctx()
    ctx.config = dict(tiny.config("qwen2.5-14b-ternary"))
    with pytest.raises(SystemExit, match="has no loss"):
        train_steps.Training(ctx)
