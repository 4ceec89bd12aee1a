"""The control comes out not correct: the plain reference computed in
float8 e4m3 (the precision below the configurations' bf16) in the
program's place, held to each cell's own limits.  At sizes a CPU test
run holds (serving at `tiny.py`'s small size, 16 layers deep; training
at its tiny size); `bench/calibrate.py` reads the same control on the
card at the cells' own sizes."""
import pytest

from bench.devtrace import Tracer
from bench.drivers import serve_calls, train_steps
from bench.reference import prec as PREC
from bench.tests import tiny


def fails(nums: dict, limits: dict) -> bool:
    return any(nums[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", ["qwen2.5-14b-ternary.prefill",
                                  "rwkv6-7b.prefill"])
def test_serving_control_is_not_correct(cell, seed):
    ctx = tiny.serve_ctx(cell, seed=seed, size="small")
    prog = serve_calls.Serving(ctx)
    serve_calls.serve_window(ctx, prog, Tracer(False), 0.0)
    kept = prog.kept
    del prog
    nums = serve_calls.judge(ctx, kept, (PREC.F32, PREC.FP8))
    limits = ctx.cell_spec["check"]["limits"]
    assert fails(nums["fp8"], limits), nums


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_training_control_is_not_correct(seed):
    ctx = tiny.train_ctx(seed=seed)
    prog = train_steps.Training(ctx)
    prog.checked(ctx)
    batches = prog.batches[:ctx.mix["checked_steps"]]
    del prog
    ref = train_steps.reference_steps(ctx, batches)
    ctl = train_steps.reference_steps(ctx, batches, PREC.FP8)
    nums = train_steps.gaps(ctl, ref)
    assert fails(nums, ctx.cell_spec["check"]["limits"]), nums
