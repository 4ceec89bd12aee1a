"""Batched serving example on the port: prefill + greedy decode over
request buckets.

The port of `examples/serve_lm.py`: runs on `--device` (default the
current CUDA device; `cpu` runs the plain PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
(thin wrapper over `python -m repro_torch.launch.serve --arch llama3.2-1b
--reduced`)
"""
import sys

from repro_torch.launch.serve import main as serve_main


if __name__ == "__main__":
    argv = ["--arch", "llama3.2-1b", "--requests", "8", "--max-new", "12"]
    serve_main(argv + sys.argv[1:])
