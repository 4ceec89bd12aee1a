"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files and entries alone: in a copy of the benchmark, with no
edit to its code, the harness finds and runs them (on the CPU, at a tiny
size).  So is a new architecture: a tiny mixture of experts, whose
reference module is one more file under `bench/reference/`."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DRIVE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from bench import harness
assert harness.BENCH.parent == __import__("pathlib").Path(sys.argv[1])
bench = harness.benchmark()
wl = harness.workload(bench, "tiny-rwkv.bursty")
cell, config, mix = harness.cell_files(wl["name"])
ctx = harness.Ctx(wl["name"], cell, config, mix, 3, 0.0, False,
                  torch.device("cpu"), time.perf_counter())
run = harness.driver(mix["kind"]).run(ctx)
e2e = harness.result(run, harness.metrics_for(bench, wl["name"], False))
per = harness.metrics_for(bench, wl["name"], True)
print(json.dumps({"e2e": e2e, "per_layer": [m["name"] for m in per],
                  "calls_in_cycle": harness.reader("calls_in_cycle")(run)}))
"""


def add_files(root: Path) -> None:
    bench = root / "bench"
    cfg = json.loads((bench / "configs" / "rwkv6-7b.json").read_text())
    cfg["name"] = "tiny-rwkv"
    cfg["model"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_head=16, d_ff=128, vocab=128)
    cfg["model"]["ssm"].update(rwkv_head_size=16, lora_rank=4)
    (bench / "configs" / "tiny-rwkv.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "prefill_calls.json").read_text())
    mix.update(prompt_lengths=[4, 12], length_shares=[0.75, 0.25],
               requests_per_call=4, calls_per_cycle=2, max_batch=2,
               cache_len=13)
    (bench / "traffic" / "bursty.json").write_text(json.dumps(mix))
    cell = {"config": "tiny-rwkv", "traffic": "bursty", "why": "a test",
            "check": {"sample": {"4": 2, "12": 1},
                      "limits": {"logit_gap": 1.0, "logit_err": 1.0}}}
    (bench / "cells" / "tiny-rwkv.bursty.json").write_text(json.dumps(cell))
    (bench / "metrics" / "calls_in_cycle.py").write_text(
        "def read(run):\n    return run.mix['calls_per_cycle']\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-rwkv", "source": "a test",
                         "file": "bench/configs/tiny-rwkv.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-rwkv.bursty", "config": "tiny-rwkv",
                           "traffic": "bursty", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "serve_tokens_per_s" == m["name"]:
            m["workloads"].append("tiny-rwkv.bursty")
    b["per_layer"].append({"name": "calls_in_cycle", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "serve_tokens_per_s",
                           "workloads": ["tiny-rwkv.bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_added_files_are_found_and_run(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    add_files(copy)
    out = subprocess.run([sys.executable, "-c", DRIVE, str(copy),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["e2e"]["correct"] is True
    assert set(res["e2e"]["metrics"]) == {"serve_tokens_per_s",
                                          "peak_mem_gib", "setup_s"} - \
        {"peak_mem_gib"}
    assert res["per_layer"] == ["calls_in_cycle"]
    assert res["calls_in_cycle"] == 2


MOE_MODULE = '''"""A tiny mixture of experts in plain PyTorch: qwen2's attention, then
in every layer a softmax router over E SwiGLU experts, the top k taken
and their weights renormalized by their sum, no token dropped."""
import math

import torch
import torch.nn.functional as F

from bench import roofline, weights
from bench.reference import qwen2
from bench.reference.common import logits, rms_norm  # noqa: F401
from bench.reference.prec import F32

consts = qwen2.consts
ternary_shapes = qwen2.ternary_shapes


def leaves(model):
    D, Fe, E = model["d_model"], model["d_ff"], model["moe"]["n_experts"]
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    dt = weights.DTYPES[model["param_dtype"]]
    at, moe = ("layers", "attn"), ("layers", "moe")
    out = weights.base_leaves(model)
    for n, N in (("wq", H * dh), ("wk", K * dh), ("wv", K * dh)):
        out += weights.proj(at + (n,), D, N, dt, True)
    out += weights.proj(at + ("wo",), H * dh, D, dt,
                        residual_depth=model["n_layers"])
    Leaf = weights.Leaf
    out += [Leaf(moe + ("router", "w"), (D, E), torch.float32,
                 ("normal", 0.02), True),
            Leaf(moe + ("experts", "w_gate"), (E, D, Fe), dt,
                 ("normal", D ** -0.5), True),
            Leaf(moe + ("experts", "w_up"), (E, D, Fe), dt,
                 ("normal", D ** -0.5), True),
            Leaf(moe + ("experts", "w_down"), (E, Fe, D), dt,
                 ("normal", Fe ** -0.5), True)]
    return out


def experts(model, p, h, prec):
    E, k = model["moe"]["n_experts"], model["moe"]["top_k"]
    probs = torch.softmax(h.float() @ p["router"]["w"].float(), dim=-1)
    top = probs.topk(k, dim=-1)
    w = top.values / top.values.sum(-1, keepdim=True)
    ex, y = p["experts"], torch.zeros_like(h)
    for e in range(E):
        g = F.silu(prec.mm(h, ex["w_gate"][e])) * prec.mm(h, ex["w_up"][e])
        share = (w * (top.indices == e)).sum(-1, keepdim=True)
        y = y + share * prec.mm(g, ex["w_down"][e])
    return y


def layer(model, lp, x, tables, prec=F32, index=0):
    x = qwen2.attend(model, lp, x, tables, prec)
    h = prec.q(rms_norm(x, lp["ln2"]["scale"], model["norm_eps"]))
    return prec.q(x + prec.q(experts(model, lp["moe"], h, prec)))


def seq_flops(model, S, n_layers):
    """2 for each parameter a token passes, its k experts of E, and each
    layer's causal attention."""
    E, k = model["moe"]["n_experts"], model["moe"]["top_k"]
    layout = leaves(model)
    routed = sum(math.prod(lf.shape) * len(weights.present(lf, n_layers))
                 for lf in layout if "experts" in lf.path)
    n = weights.counts(layout, n_layers)["layers"] - routed + routed // E * k
    return roofline.model_flops(n, S, "serve") + n_layers * \\
        roofline.attention_flops(S, model["n_heads"], model["d_head"])
'''

MOE_MODEL = {"name": "tiny-moe", "family": "moe", "n_layers": 2, "d_model": 64,
             "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 32,
             "vocab": 128, "rope": "std", "rope_theta": 10000.0,
             "qkv_bias": True, "norm": "rmsnorm", "norm_eps": 1e-5,
             "tie_embeddings": False, "act": "swiglu", "quant": "dense",
             "param_dtype": "float32", "compute_dtype": "float32",
             "attn_block_k": 16,
             # capacity E / k: an expert has a slot for every token
             "moe": {"n_experts": 4, "top_k": 2, "capacity_factor": 2.0}}

DRIVE_MOE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from bench import harness
bench = harness.benchmark()
wl = harness.workload(bench, "tiny-moe.short_calls")
cell, config, mix = harness.cell_files(wl["name"])
ctx = harness.Ctx(wl["name"], cell, config, mix, 2 ** 31 + 77, 0.0, False,
                  torch.device("cpu"), time.perf_counter())
run = harness.driver(mix["kind"]).run(ctx)
e2e = harness.result(run, harness.metrics_for(bench, wl["name"], False))
per = harness.metrics_for(bench, wl["name"], True)
print(json.dumps({"e2e": e2e, "per_layer": [m["name"] for m in per],
                  "mfu": harness.reader("mfu.serve")(run),
                  "requests": run.work["requests"],
                  "window_s": run.window_s}))
"""


def add_architecture(root: Path) -> None:
    bench = root / "bench"
    (bench / "reference" / "tiny_moe.py").write_text(MOE_MODULE)
    (bench / "configs" / "tiny-moe.json").write_text(json.dumps(
        {"name": "tiny-moe", "source": "a test", "reference": "tiny_moe",
         "model": MOE_MODEL}))
    mix = json.loads((bench / "traffic" / "prefill_calls.json").read_text())
    mix.update(prompt_lengths=[4, 12], length_shares=[0.75, 0.25],
               requests_per_call=4, calls_per_cycle=2, max_batch=2,
               cache_len=13)
    (bench / "traffic" / "short_calls.json").write_text(json.dumps(mix))
    cell = {"config": "tiny-moe", "traffic": "short_calls", "why": "a test",
            "check": {"sample": {"4": 2, "12": 1},
                      "limits": {"logit_gap": 1e-3, "logit_err": 1e-3}}}
    (bench / "cells" / "tiny-moe.short_calls.json").write_text(
        json.dumps(cell))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-moe", "source": "a test",
                         "file": "bench/configs/tiny-moe.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-moe.short_calls",
                           "config": "tiny-moe", "traffic": "short_calls",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("serve_tokens_per_s", "request_p95_ms",
                         "mfu.serve"):
            m["workloads"].append("tiny-moe.short_calls")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def hand_count(requests: list, window_s: float) -> tuple[float, float]:
    """`mfu.serve` of the tiny MoE counted by hand: a token passes the
    norms, attention, the router and its top 2 of 4 experts (the final
    norm counted with the layers, as for every architecture here), each
    layer's causal pairs cost 4 H dh, the head 2 D V a served position;
    beside it the same with all 4 experts."""
    m = MOE_MODEL
    D, F, L, V = m["d_model"], m["d_ff"], m["n_layers"], m["vocab"]
    H, K, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    attn = D * H * dh + H * dh + 2 * (D * K * dh + K * dh) + H * dh * D
    expert = 3 * D * F
    out = []
    for n_experts in (2, 4):
        n = L * (2 * D + attn + D * 4 + n_experts * expert) + D
        flops = sum(2 * n * (p + got - 1) + L * 4 * H * dh * (p + got - 1)
                    * (p + got) / 2 + 2 * D * V * got
                    for p, got, _, _ in requests)
        out.append(100 * flops / (window_s * 989e12))
    return out[0], out[1]


def test_a_new_architecture_is_added_as_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = digests(copy / "bench")
    add_architecture(copy)
    out = subprocess.run([sys.executable, "-c", DRIVE_MOE, str(copy),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["e2e"]["correct"] is True, res["e2e"]["checks"]
    assert set(res["e2e"]["metrics"]) == {"serve_tokens_per_s",
                                          "request_p95_ms", "setup_s"}
    assert res["per_layer"] == ["mfu.serve"]
    top_k, every = hand_count(res["requests"], res["window_s"])
    assert res["mfu"] == pytest.approx(top_k, rel=1e-12)
    assert res["mfu"] != pytest.approx(every, rel=1e-3)
    after = digests(copy / "bench")
    assert {k: after[k] for k in before} == before
