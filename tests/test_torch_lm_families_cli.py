"""`python -m repro_torch.launch.serve --device cpu --reduced --arch <id>`
exits 0 and serves every request for each arch the LM-families slice
added (ternary_packed, or dense for hymba, which serves dense only), and
for llama3.2-1b with an fp8 KV cache.  (llama3.2-1b and rwkv6-7b without
it: `tests/test_torch_lm_engine.py`, `tests/test_torch_rwkv_model.py`.)
"""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE_ONLY = {"hymba-1.5b", "rwkv6-7b"}


@pytest.mark.parametrize("args", [
    [a] + (["--quant", "dense"] if a in DENSE_ONLY else
           ["--quant", "ternary_packed"])
    for a in ARCHS if a not in ("llama3.2-1b", "rwkv6-7b")]
    + [["llama3.2-1b", "--kv-cache-dtype", "float8_e4m3fn"]],
    ids=lambda a: "-".join(a))
def test_serve_cli_runs_each_arch_on_cpu(args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--requests", "3", "--max-new", "3", "--arch", *args],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "on cpu | 3 requests, 9 tokens" in out.stdout
