"""Nothing the benchmark runs loads JAX or the JAX package (`repro`),
compared by each module's top-level name whole; the reference loads
nothing of the program either."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "repro"}

RUN = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from bench import harness
from bench.drivers import serve_calls, train_steps
from bench.tests import tiny
for m in (harness.BENCH / "metrics").glob("*.py"):
    harness.reader(m.stem)
serve_calls.run(tiny.serve_ctx("rwkv6-7b.prefill"))
serve_calls.run(tiny.serve_ctx("qwen2.5-14b-ternary.prefill"))
train_steps.run(tiny.train_ctx())
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""

REFERENCE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1]]
import bench.reference
for m in pkgutil.iter_modules(bench.reference.__path__):
    importlib.import_module("bench.reference." + m.name)
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""


def top_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = top_modules(RUN)
    assert "repro_torch" in mods          # the program did run
    assert not mods & BANNED


def test_the_reference_loads_nothing_of_the_program():
    mods = top_modules(REFERENCE)
    assert not mods & (BANNED | {"repro_torch"})


def test_no_source_under_bench_names_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in BANNED, (path, line)
                if "reference" in path.parts:
                    assert words[1].split(".")[0] != "repro_torch", (path,
                                                                     line)


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "rwkv6-7b.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
