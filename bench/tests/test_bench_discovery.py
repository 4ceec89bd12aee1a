"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files and entries alone: in a copy of the benchmark, with no
edit to its code, the harness finds and runs them (on the CPU, at a tiny
size)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

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
