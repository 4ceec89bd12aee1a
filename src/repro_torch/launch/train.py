"""Command line for LM training through the `Trainer`.

    # reduced-config smoke train of any reference arch
    python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 20

    # the ~100M-parameter llama-style preset for a few hundred steps
    python -m repro_torch.launch.train --preset lm100m --steps 300 \
        --ckpt-dir /tmp/ckpt_lm100m

    # the paper's technique at LM scale: ternary QAT
    python -m repro_torch.launch.train --preset lm100m --quant ternary

The port of `repro.launch.train`, with its flags and `--device` (default
the current CUDA device; `cpu` runs the plain PyTorch versions).  Weights
come from `models.params.init_params(cfg, --seed)` (PyTorch's generator,
not the reference's numbers); the token stream is the reference's
(`data.tokens`).  A checkpoint found in `--ckpt-dir` is resumed.  The last
line is JSON: first and last loss, steps, stragglers.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params, param_count
from repro_torch.optim import adamw, adamw8bit
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.grad_compress import init_error_buffer
from repro_torch.train.loop import Trainer, TrainLoopConfig


def preset_lm100m() -> ModelConfig:
    """~100M-param llama-style config (the reference's `lm100m`)."""
    return ModelConfig(
        name="lm100m", family="dense", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=4, d_head=64, d_ff=1536, vocab=8192,
        rope="std", rope_theta=1e4, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat=False)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[None, "lm100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default=None,
                    choices=[None, "dense", "ternary"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    args = ap.parse_args(argv)

    if args.preset == "lm100m":
        cfg = preset_lm100m()
    elif args.arch:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    else:
        raise SystemExit("pass --arch or --preset")
    if args.quant:
        cfg = cfg.replace(quant=args.quant)
    dev = resolve_device(args.device)

    print(f"config {cfg.name}: {param_count(cfg)/1e6:.1f}M params, "
          f"quant={cfg.quant}, device {dev}")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed), device=dev)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, log_every=10,
        grad_compress=args.grad_compress,
        optimizer=AdamWConfig(lr=args.lr,
                              warmup_steps=min(20, args.steps // 5),
                              total_steps=args.steps))
    trainer = Trainer(cfg, loop_cfg, pipe, args.ckpt_dir, device=dev)
    opt_mod = adamw8bit if cfg.opt_8bit else adamw

    def init_fn():
        params = init_params(cfg, seed=args.seed, device=dev)
        return params, opt_mod.init(params)

    params, opt_state, start = trainer.resume_or_init(init_fn)
    if start:
        print(f"resumed from step {start}")
    err = init_error_buffer(params) if args.grad_compress else None
    params, opt_state, result = trainer.run(params, opt_state,
                                            start_step=start, err_buf=err)
    losses = result["losses"]
    out = {"first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None,
           "steps": result["last_step"],
           "stragglers": len(result["stragglers"])}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
