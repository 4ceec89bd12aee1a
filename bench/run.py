"""The benchmark's one command, run from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It runs the cell of `BENCHMARK.json` named by `--workload` on the first
CUDA device and prints its result as the last line of standard output
(`bench/harness.py`).  It exits non-zero, printing no result, without a
card, or when the process has loaded JAX or the JAX package.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache the process might use lives inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
# the checkout and its sources, not this script's folder, are importable
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
