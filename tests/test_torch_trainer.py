"""The port's training loop (`repro_torch.train.loop`), on the CPU.

Counterparts of the reference's `tests/test_system.py::
test_trainer_loss_decreases_and_resumes` and `::
test_trainer_microbatch_equivalence`, and of `tests/test_fault_tolerance.
py`'s preemption and straggler tests, with the port's own weights
(`init_params`, PyTorch's generator) on the reference's token stream;
plus the resume held bit for bit (restored tensors equal the saved ones,
the step and the stream continue), a step with gradient compression and
8-bit moments, and the `launch.train` CLI.  Tolerances are the
reference tests' own.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: E402,E501
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim import adamw, adamw8bit  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, tree_leaves  # noqa: E402
from repro_torch.optim.grad_compress import init_error_buffer  # noqa: E402
from repro_torch.train.loop import (StepStats, Trainer,  # noqa: E402
                                    TrainLoopConfig, make_train_step)

ROOT = Path(__file__).resolve().parents[1]


def _pipe(cfg, S, B, seed=0):
    return TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B, seed=seed),
                         device="cpu")


def test_trainer_loss_decreases_and_resumes(tmp_path):
    cfg = get_config("qwen2-1.5b").reduced()
    pipe = _pipe(cfg, 32, 4)
    tr = Trainer(cfg, TrainLoopConfig(total_steps=8, ckpt_every=4,
                                      log_every=100,
                                      optimizer=AdamWConfig(lr=3e-3)),
                 pipe, str(tmp_path), device="cpu")
    params = init_params(cfg, 0, "cpu")
    params, opt, res = tr.run(params, adamw.init(params),
                              log=lambda s: None)
    assert res["losses"][-1] < res["losses"][0]
    assert res["last_step"] == 8 and tr.ckpt.all_steps() == [4, 8]
    # resume: a fresh Trainer restores step 8 bit for bit
    tr2 = Trainer(cfg, TrainLoopConfig(total_steps=10, ckpt_every=4,
                                       optimizer=AdamWConfig(lr=3e-3)),
                  pipe, str(tmp_path), device="cpu")
    p0 = init_params(cfg, 0, "cpu")
    p2, opt2, start = tr2.resume_or_init(lambda: (p0, adamw.init(p0)))
    assert start == 8
    for a, b in zip(tree_leaves({"p": params, "m": opt.mu, "v": opt.nu}),
                    tree_leaves({"p": p2, "m": opt2.mu, "v": opt2.nu})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(opt2.step) == 8 and opt2.step.dtype == torch.int32


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """Stopping at step 3 and resuming gives the run that never stopped,
    bit for bit on the CPU: the state and the stream both continue."""
    cfg = get_config("llama3.2-1b").reduced()
    pipe = _pipe(cfg, 16, 2)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def run(total, directory, start_state=None):
        tr = Trainer(cfg, TrainLoopConfig(total_steps=total, ckpt_every=3,
                                          optimizer=ocfg), pipe,
                     str(directory), device="cpu")
        p = init_params(cfg, 0, "cpu")
        p, o, s = tr.resume_or_init(lambda: (p, adamw.init(p)))
        return tr.run(p, o, start_step=s, log=lambda m: None)

    p_full, _, res_full = run(6, tmp_path / "a")
    run(3, tmp_path / "b")
    p_res, _, res_res = run(6, tmp_path / "b")
    assert res_res["losses"] == res_full["losses"][3:]
    for a, b in zip(tree_leaves(p_full), tree_leaves(p_res)):
        assert torch.equal(a, b)


def test_trainer_microbatch_equivalence():
    """Gradient accumulation over 2 microbatches ~ one full-batch step."""
    cfg = get_config("llama3.2-1b").reduced()
    batch = _pipe(cfg, 16, 4).batch_at(0)
    params = init_params(cfg, 0, "cpu")
    ocfg = AdamWConfig(lr=1e-3, grad_clip=None)
    s1 = make_train_step(cfg, TrainLoopConfig(microbatches=1,
                                              optimizer=ocfg))
    s2 = make_train_step(cfg, TrainLoopConfig(microbatches=2,
                                              optimizer=ocfg))
    p1, _, m1, _ = s1(params, adamw.init(params), batch, None)
    p2, _, m2, _ = s2(params, adamw.init(params), batch, None)
    d = max(float((a - b).abs().max())
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-4
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    assert float(m2["tokens"]) == float(m1["tokens"]) == 4 * 16
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainLoopConfig(microbatches=3))(
            params, adamw.init(params), batch)


def test_compressed_8bit_steps_train():
    """int8 moments and int8 gradient compression: finite, falling loss;
    the error buffer carries the residual."""
    cfg = get_config("rwkv6-7b").reduced().replace(opt_8bit=True)
    pipe = _pipe(cfg, 16, 4)
    params = init_params(cfg, 0, "cpu")
    opt, err = adamw8bit.init(params), init_error_buffer(params)
    step = make_train_step(cfg, TrainLoopConfig(
        microbatches=2, grad_compress=True,
        optimizer=AdamWConfig(lr=3e-3)))
    losses = []
    for i in range(8):
        params, opt, met, err = step(params, opt, pipe.batch_at(i), err)
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert isinstance(opt, adamw8bit.AdamW8bitState) and int(opt.step) == 8
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(err))


def test_packed_weights_are_refused():
    cfg = get_config("llama3.2-1b").reduced().replace(quant="ternary_packed")
    params = init_params(cfg, 0, "cpu")
    step = make_train_step(cfg.replace(quant="ternary_packed"),
                           TrainLoopConfig())
    with pytest.raises(ValueError, match="packed"):
        step(params, adamw.init({"x": torch.zeros(1)}),
             _pipe(cfg, 8, 2).batch_at(0))


def test_preemption_checkpoint(tmp_path):
    """The preempt flag (SIGTERM/SIGINT) forces a checkpoint and a stop."""
    cfg = get_config("llama3.2-1b").reduced()
    tr = Trainer(cfg, TrainLoopConfig(total_steps=50, ckpt_every=100,
                                      optimizer=AdamWConfig(lr=1e-3)),
                 _pipe(cfg, 16, 2), str(tmp_path), device="cpu")
    params = init_params(cfg, 0, "cpu")
    calls = []
    orig_record = tr.stats.record

    def record_and_preempt(step, dt, factor):
        if step >= 1:
            tr._preempted = True
        return orig_record(step, dt, factor)

    tr.stats.record = record_and_preempt
    _, _, result = tr.run(params, adamw.init(params), log=calls.append)
    assert result["last_step"] < 50
    assert tr.ckpt.latest_step() == result["last_step"]
    assert any("[preempt]" in c for c in calls)
    _, _, extra = tr.ckpt.restore(
        {"params": params, "opt": adamw.init(params)}, device="cpu")
    assert extra.get("preempted") is True


def test_signal_handlers_set_the_flag_and_are_restored(tmp_path):
    import os
    import signal

    cfg = get_config("llama3.2-1b").reduced()
    tr = Trainer(cfg, TrainLoopConfig(total_steps=20, ckpt_every=100),
                 _pipe(cfg, 8, 2), str(tmp_path), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    orig_record = tr.stats.record

    def record_and_signal(step, dt, factor):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig_record(step, dt, factor)

    tr.stats.record = record_and_signal
    params = init_params(cfg, 0, "cpu")
    _, _, result = tr.run(params, adamw.init(params), log=lambda m: None)
    assert result["last_step"] == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_detection_flags_slow_steps():
    stats = StepStats()
    flagged = [step for step in range(20)
               if stats.record(step, 1.0 if step != 15 else 5.0, 3.0)]
    assert flagged == [15]
    assert stats.stragglers[0][0] == 15


def test_straggler_needs_history():
    assert not StepStats().record(0, 100.0, factor=3.0)


def test_trainer_needs_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainLoopConfig(), None, str(tmp_path))


def test_launch_train_cli_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--reduced", "--steps", "6", "--batch", "4",
         "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "3", "--quant", "ternary"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["steps"] == 6 and res["last_loss"] < res["first_loss"]
    assert "quant=ternary" in out.stdout
    # a second call resumes the finished run and trains no step
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--reduced", "--steps", "6", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--quant", "ternary"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert "resumed from step 6" in again.stdout
    assert json.loads(again.stdout.strip().splitlines()[-1])["steps"] == 6
