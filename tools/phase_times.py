#!/usr/bin/env python3
"""Seconds each phase of a JSON-lines program takes, from when its lines
arrive.

    python3 tools/phase_times.py --out times.json -- python3 chip_smoke.py

Runs the command, passes its standard output through unchanged and, for
each line, notes the seconds since the start.  A line that is a JSON
object with a `phase` key ends a stretch of time that started at the line
before it (or at the start), and that stretch is counted to the phase;
the stretch after the last such line is counted to `"(rest)"`.  A phase
that prints several lines gets the sum of their stretches.  Written to
`--out`: `{"command", "returncode", "seconds", "phases": {name: seconds},
"lines": [[seconds, phase or null], ...]}`.  Exits with the command's
code.  Works on any program that prints one JSON object a phase, so two
versions of `chip_smoke.py` can be timed alike without changing either.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command given")
    t0 = time.monotonic()
    last = 0.0
    phases: dict[str, float] = {}
    lines = []
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                          bufsize=1) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            now = time.monotonic() - t0
            try:
                obj = json.loads(line)
            except ValueError:
                obj = None
            phase = obj.get("phase") if isinstance(obj, dict) else None
            lines.append([now, phase])
            if isinstance(phase, str):
                phases[phase] = phases.get(phase, 0.0) + now - last
                last = now
    total = time.monotonic() - t0
    phases["(rest)"] = total - last
    with open(args.out, "w") as f:
        json.dump({"command": cmd, "returncode": proc.returncode,
                   "seconds": total, "phases": phases, "lines": lines}, f,
                  indent=1)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
