"""Mellum's cell joins as files alone, and its numbers are what they say.

In a copy of the benchmark, a tiny Mellum (one whole period of its layer
pattern: three windowed layers and one full one, 4 ternary experts top 2,
routed dropless) runs through the cell's own driver on the CPU: correct,
every file that was there unchanged, `mfu.serve` the hand count (window
pairs on windowed layers, causal pairs on the full one, 2 of 4 experts
and the router), `expert_gemm_roofline.serve` its hand bound.  At a size
deep enough for precision to show, the float8 control fails the cell's
own limit; the reference module imports nothing of the program."""
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.devtrace import Tracer
from bench.drivers import serve_calls
from bench.reference import prec as PREC

ROOT = Path(__file__).resolve().parents[2]
CELL = "mellum2-12b-a2.5b-ternary.code_prefill"
KINDS = ["sliding_attention"] * 3 + ["full_attention"]

DRIVE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from bench import harness
bench = harness.benchmark()
wl = harness.workload(bench, "tiny-mellum.calls")
cell, config, mix = harness.cell_files(wl["name"])
ctx = harness.Ctx(wl["name"], cell, config, mix, 2 ** 31 + 99, 0.0, False,
                  torch.device("cpu"), time.perf_counter())
run = harness.driver(mix["kind"]).run(ctx)
e2e = harness.result(run, harness.metrics_for(bench, wl["name"], False))


class Kernels:
    def kernel_seconds(self, names):
        return (1e-3, 1) if names == ("expert_mma_kernel",) else (0.0, 0)


run.trace = Kernels()
print(json.dumps({"e2e": e2e, "mfu": harness.reader("mfu.serve")(run),
                  "roofline": harness.reader("expert_gemm_roofline.serve")(run),
                  "requests": run.work["requests"],
                  "groups": run.work["groups"], "window_s": run.window_s}))
"""


def tiny_model(dtype: str = "float32") -> dict:
    cfg = harness.load_json(harness.BENCH / "configs"
                            / "mellum2-12b-a2.5b-ternary.json")
    m = cfg["model"]
    m.update(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=32, vocab=128, swa_window=8, attn_block_k=16,
             layer_types=KINDS, param_dtype=dtype, compute_dtype=dtype,
             moe=dict(m["moe"], n_experts=4, top_k=2))
    return m


def add_files(root: Path) -> None:
    bench = root / "bench"
    cfg = harness.load_json(bench / "configs"
                            / "mellum2-12b-a2.5b-ternary.json")
    cfg.update(name="tiny-mellum", model=tiny_model())
    (bench / "configs" / "tiny-mellum.json").write_text(json.dumps(cfg))
    mix = harness.load_json(bench / "traffic" / "code_context_calls.json")
    mix.update(prompt_lengths=[12, 20], length_shares=[0.5, 0.5],
               requests_per_call=4, calls_per_cycle=2, max_batch=2,
               cache_len=21)
    (bench / "traffic" / "tiny_calls.json").write_text(json.dumps(mix))
    cell = harness.load_json(bench / "cells" / f"{CELL}.json")
    cell.update(config="tiny-mellum", traffic="tiny_calls", check={
        "sample": {"12": 2, "20": 2}, "limits": {"logit_err": 1e-3}})
    (bench / "cells" / "tiny-mellum.calls.json").write_text(json.dumps(cell))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-mellum", "source": "a test",
                         "file": "bench/configs/tiny-mellum.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-mellum.calls",
                           "config": "tiny-mellum", "traffic": "tiny_calls",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-mellum.calls")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def hand_mfu(requests: list, window_s: float, n_experts: int) -> float:
    """A token passes two norms, q/k/v/o without bias, the router and
    `n_experts` SwiGLU experts a layer, and the final norm; windowed layers
    see min(i + 1, 8) keys at position i, the full layer i + 1, each pair
    4 H dh; the head 2 D V a served position."""
    m = tiny_model()
    D, F, L, V = m["d_model"], m["d_ff"], m["n_layers"], m["vocab"]
    H, K, dh, E = m["n_heads"], m["n_kv_heads"], m["d_head"], 4
    attn = 2 * D * H * dh + 2 * D * K * dh
    n = L * (2 * D + attn + D * E + n_experts * 3 * D * F) + D
    flops = 0.0
    for p, got, _, _ in requests:
        S = p + got - 1
        pairs = sum(min(i + 1, 8) if kind == "sliding_attention" else i + 1
                    for kind in KINDS for i in range(S))
        flops += 2 * n * S + 4 * H * dh * pairs + 2 * D * V * got
    return 100 * flops / (window_s * 989e12)


def hand_bound(groups: list) -> float:
    """Each layer's three expert matrices a group: for each of the 4
    experts, T * 2 / 4 rows; bytes (bf16 x, 2-bit codes, f32 scale and
    out) at 3.35 TB/s against 2 M K N at 989 TFLOP/s."""
    m = tiny_model()
    D, F, L = m["d_model"], m["d_ff"], m["n_layers"]
    total = 0.0
    for rows, S in groups:
        M = rows * S * 2 / 4
        for K, N in ((D, F), (D, F), (F, D)):
            b = M * K * 2 + K // 4 * N + 4 * N + 4 * M * N
            total += 4 * max(b / 3.35e12, 2 * M * K * N / 989e12)
    return L * total


def test_a_tiny_mellum_joins_as_files_and_reads_as_counted(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = digests(copy / "bench")
    add_files(copy)
    out = subprocess.run([sys.executable, "-c", DRIVE, str(copy),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["e2e"]["correct"] is True, res["e2e"]["checks"]
    assert set(res["e2e"]["metrics"]) == {"serve_tokens_per_s",
                                          "request_p95_ms", "setup_s"}
    assert res["mfu"] == pytest.approx(
        hand_mfu(res["requests"], res["window_s"], 2), rel=1e-12)
    assert res["mfu"] != pytest.approx(
        hand_mfu(res["requests"], res["window_s"], 4), rel=1e-3)
    assert res["roofline"] == pytest.approx(
        100 * hand_bound(res["groups"]) / 1e-3, rel=1e-12)
    after = digests(copy / "bench")
    assert {k: after[k] for k in before} == before


def small_ctx(seed: int) -> harness.Ctx:
    """The cell at a size deep enough that precision shows (4 periods,
    d_model 512, 8 experts top 2, window 32), in bf16, on the CPU."""
    spec, cfg, mix = harness.cell_files(CELL)
    m = cfg["model"]
    m.update(n_layers=16, d_model=512, n_heads=8, n_kv_heads=2, d_head=64,
             d_ff=256, vocab=8192, swa_window=32, attn_block_k=128,
             layer_types=KINDS * 4, moe=dict(m["moe"], n_experts=8, top_k=2))
    mix = dict(mix, prompt_lengths=[32, 64, 128], cache_len=129)
    spec = dict(spec, check=dict(spec["check"], sample={
        "32": 2, "64": 4, "128": 2}))
    return harness.Ctx(CELL, spec, cfg, mix, seed, 0.0, False,
                       torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("seed", [21, 22])
def test_the_control_is_not_correct(seed):
    ctx = small_ctx(seed)
    prog = serve_calls.Serving(ctx)
    serve_calls.serve_window(ctx, prog, Tracer(False), 0.0)
    kept = prog.kept
    del prog
    nums = serve_calls.judge(ctx, kept, (PREC.F32, PREC.FP8))
    limit = ctx.cell_spec["check"]["limits"]["logit_err"]
    assert nums["fp8"]["logit_err"] > limit, nums


def test_the_reference_names_nothing_of_the_program():
    banned = {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    src = (ROOT / "bench" / "reference" / "mellum.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in banned, line
