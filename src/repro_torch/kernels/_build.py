"""Build the CUDA sources under `csrc/` into shared libraries, at first use.

Each `.cu` file is compiled by `nvcc` on its own into a `.so` with a plain
C interface (no PyTorch headers, so a build takes seconds) and loaded with
`ctypes`.  Libraries land in `build/repro_torch/` at the repository root,
named by a digest of the source, the headers beside it (`csrc/*.cuh`) and
the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is.  All requested sources compile in parallel, one
`nvcc` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels need the "
                       "CUDA toolkit to build")


def library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to: keyed on its content, the
    headers' and the flags."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def build(sources: list[str]) -> dict[str, Path]:
    """Compile every source whose library is missing, all at once.

    Returns `{source: library path}`.  The compiler's report (`-Xptxas -v`:
    registers, shared memory and spills per kernel) is kept beside each
    library as `<lib>.log`.  Raises `RuntimeError` with nvcc's output when
    a build fails.
    """
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        procs[s] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[s].with_name(todo[s].name + ".log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed on {s} (exit {proc.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build([source])[source]))
        return _loaded[source]
