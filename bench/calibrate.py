"""Read the numbers a cell's correctness limits are set from, on the card
at the cell's own size, many seeds in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--controls fp8 fp8_held half_batch] [--out FILE]

For each seed the program runs as the benchmark runs it (set-up, then,
for serving, one cycle of the mix as its window) and is held against the
float32 reference; on the first `--control-seeds` seeds the control is
read too: the reference in the program's place with its products'
operands in float8 e4m3 (`fp8`), for the record also with every tensor
the program holds in bf16 in float8 (`fp8_held`), and for training the
planted fault of half of each microbatch left out (a state left
unchanged reads 1 on `update_gap` by definition).  Prints one JSON line
a seed and, last, the largest program reading and the smallest control
and fault readings of each number.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def serve_seed(ctx, controls: tuple) -> dict:
    from bench.devtrace import Tracer
    from bench.drivers import release, serve_calls
    from bench.reference import prec as PREC

    prog = serve_calls.Serving(ctx)
    serve_calls.serve_window(ctx, prog, Tracer(False), 0.0)
    kept = prog.kept
    del prog
    release(ctx.device)
    precs = [p for p in (PREC.FP8, PREC.FP8Held) if p.name in controls]
    return serve_calls.judge(ctx, kept, (PREC.F32, *precs))


def train_seed(ctx, controls: tuple) -> dict:
    from bench.drivers import release, train_steps as T
    from bench.reference import prec as PREC

    prog = T.Training(ctx)
    checked = prog.checked(ctx)
    batches = prog.batches[:ctx.mix["checked_steps"]]
    del prog
    release(ctx.device)
    ref = T.reference_steps(ctx, batches)
    out = {"f32": T.gaps(checked, ref)}
    for p in (PREC.FP8, PREC.FP8Held):
        if p.name in controls:
            out[p.name] = T.gaps(T.reference_steps(ctx, batches, p), ref)
    if "half_batch" in controls:
        out["half_batch"] = T.gaps(T.reference_steps(ctx, batches,
                                                     half_batch=True), ref)
    out["losses"] = {"program": checked["losses"], "reference": ref["losses"]}
    return out


def main() -> int:
    import argparse

    import torch

    from bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", nargs="*",
                    default=["fp8", "fp8_held", "half_batch"])
    ap.add_argument("--out")
    a = ap.parse_args()
    cell, config, mix = harness.cell_files(a.workload)
    one = serve_seed if mix["kind"] == "serve_calls" else train_seed
    rows = []
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        ctx = harness.Ctx(a.workload, cell, config, mix, seed, 0.0, False,
                          torch.device("cuda", 0), t0)
        row = {"seed": seed,
               **one(ctx, a.controls if i < a.control_seeds else ()),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    names = [k for k, v in rows[0]["f32"].items()
             if isinstance(v, float)]
    summary = {"lower": {n: max(r["f32"][n] for r in rows) for n in names}}
    for side in ("fp8", "fp8_held", "half_batch"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = {n: min(g[n] for g in got) for n in names}
    summary["card"] = harness.card_limits()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
