"""`tools/phase_times.py`: the output passes through unchanged, each
JSON `phase` line ends a stretch counted to that phase, and the command's
exit code comes back."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = """
import json, sys, time
print(json.dumps({"phase": "a"}), flush=True)
time.sleep(0.3)
print("not json", flush=True)
print(json.dumps({"phase": "b", "x": 1}), flush=True)
time.sleep(0.2)
print(json.dumps({"phase": "a"}), flush=True)
print(json.dumps({"ok": True}), flush=True)
sys.exit(int(sys.argv[1]))
"""


@pytest.mark.parametrize("code", [0, 3])
def test_phase_times(tmp_path, code):
    out = tmp_path / "times.json"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "phase_times.py"), "--out",
         str(out), "--", sys.executable, "-c", PROGRAM, str(code)],
        capture_output=True, text=True, timeout=60)
    assert run.returncode == code
    assert run.stdout.splitlines() == [
        '{"phase": "a"}', "not json", '{"phase": "b", "x": 1}',
        '{"phase": "a"}', '{"ok": true}']
    rec = json.loads(out.read_text())
    assert rec["returncode"] == code
    assert [p for _, p in rec["lines"]] == ["a", None, "b", "a", None]
    ph = rec["phases"]
    assert set(ph) == {"a", "b", "(rest)"}
    assert ph["b"] >= 0.25 and ph["a"] >= 0.15
    assert abs(sum(ph.values()) - rec["seconds"]) < 1e-6
