"""End-to-end LM training on the port: ~100M-param model, a few hundred
steps.

Trains the `lm100m` preset (8L/512d llama-style) on the deterministic
synthetic token stream, with checkpointing and resume; optionally with the
paper's ternary quantization (--quant ternary) to compare loss curves.
The port of `examples/train_lm.py`: runs on `--device` (default the
current CUDA device; `cpu` runs the plain PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300]
      [--quant ternary] [--device cpu]
(thin wrapper over `python -m repro_torch.launch.train --preset lm100m`)
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


if __name__ == "__main__":
    argv = ["--preset", "lm100m", "--steps", "300", "--batch", "8",
            "--seq", "256", "--ckpt-dir",
            os.path.join(tempfile.gettempdir(), "repro_torch_lm100m")]
    train_main(argv + sys.argv[1:])
