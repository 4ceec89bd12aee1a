#!/usr/bin/env python3
"""Where the WKV-6 backward kernel's time goes, on one card.

    PYTHONPATH=src python3 tools/wkv_bwd_profile.py

The card's profilers are not available to this repository's runs, so
this script takes the kernel apart instead, at rwkv6-7b's training
microbatch `(2, 256, 64, 64)` bf16 (the model's strided views, decays
down to 1e-12):

  * `sections` -- an instrumented build of `csrc/rwkv6_scan.cu` in which
    thread 0 of CTA 0 reads the SM clock at the boundaries of the
    kernel's phases (staging wait, prepare pass, checkpoint load,
    recompute, cluster wait and row sums, walk, dv sums, barrier arrive,
    dv stores) and adds each phase's cycles into registers, written out
    once at the end: one CTA's timeline, summed by phase;
  * `ablations` -- builds that each leave one piece out (the cluster
    barrier's release semantics, the recompute's stores and so the
    recompute, the staging of the next chunk, the sums across lanes) and
    are timed like the kernel.  Their outputs are wrong by construction
    and are not checked; the difference to `base` is that piece's share
    of the time.

Every build is compiled from this checkout's source text with nvcc into
a temporary directory; a source edit that moves an anchor makes the
script stop with the anchor it could not find.  Times are medians of
CUDA-event pairs after a spin kernel.  Prints one JSON line per part,
then the card's name and power limit.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SHAPE = (2, 256, 64, 64)
REPS = 25

# (the source line, stripped; the phase it ends; mark after the line?)
MARKS = [
    ("__syncthreads();  // chunk c staged; chunk c + 1's planes all read",
     "staging_wait", True),
    ("__syncthreads();  // the planes, c_t and e_t written; staging free",
     "prepare", True),
    ("load_tile(a.ck + (row * nck + c) * DH * DH, ck);", "checkpoint_load",
     True),
    ("half(t0, HALF, cnt - HALF);", "recompute", False),
    ("half(t0, 0, min(cnt, HALF));", "recompute", False),
    ("cluster_wait();  // every CTA's sums of the pending half are written",
     "cluster_wait", True),
    ("finish_rows(p_t0, p_base, p_n, p_buf);", "row_sums", True),
    ("walk(base_t, n, buf);", "walk", True),
    ("__syncthreads();  // every warp's dv sums of the half are written",
     "walk_sync", True),
    ("finish_dv(base_t, n);", "dv_sums", True),
    ("cluster_arrive();", "barrier_arrive", True),
    ("store_dv(t0, base_t, n);", "dv_store", True),
]

ABLATIONS = {
    "relaxed_arrive": [(
        'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");',
        'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
        '"memory");')],
    "no_recompute_stores": [("      if (!(s & 1)) keep(s / 2, S);",
                             "      if (s < 0) keep(s / 2, S);")],
    "no_staging": [("    if (c > 0) stage_chunk(c - 1);",
                    "    if (c < 0) stage_chunk(c - 1);")],
    "no_lane_sums": [
        ("        pv[n] = (hi ? pv[n + cnt] : pv[n]) +\n"
         "                __shfl_xor_sync(0xffffffffu, give, bit);",
         "        pv[n] = (hi ? pv[n + cnt] : pv[n]) + give;"),
        ("      p.x[n] = (odd ? p.x[n + 3] : p.x[n]) +\n"
         "               __shfl_xor_sync(0xffffffffu, give, 1);",
         "      p.x[n] = (odd ? p.x[n + 3] : p.x[n]) + give;"),
        ("      p.x[n] += __shfl_xor_sync(0xffffffffu, p.x[n], 2);",
         "      p.x[n] += p.x[n];")],
}


def replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not found in the source: {old!r}")
    return text.replace(old, new)


def instrumented(text: str) -> tuple[str, list[str]]:
    phases = list(dict.fromkeys(p for _, p, _ in MARKS))
    out, inside = [], False
    for line in text.split("\n"):
        st = line.strip()
        inside = inside or "rwkv6_scan_bwd_kernel(const BwdArgs a) {" in line
        hits = [(phases.index(p), after) for s, p, after in MARKS
                if inside and st == s]
        out += [f"WKV_MARK({i});" for i, after in hits if not after]
        out.append(line)
        if inside and st == "const int q = cluster_rank();":
            out.append(f"unsigned wkv_acc[{len(phases)}] = {{}}; "
                       "unsigned wkv_last = clock(); "
                       "const unsigned wkv_start = wkv_last;")
        if inside and st == "a.du[row * DH + q * JW + tid] = sum;":
            out.append(f"  }}\n  if (threadIdx.x == 0 && blockIdx.x == 0) {{ "
                       f"for (int i = 0; i < {len(phases)}; ++i) "
                       f"wkv_prof[i] = wkv_acc[i]; wkv_prof[{len(phases)}] "
                       "= clock() - wkv_start;")
        out += [f"WKV_MARK({i});" for i, after in hits if after]
    text = "\n".join(out)
    missing = [p for p in phases if f"WKV_MARK({phases.index(p)})" not in
               text]
    if missing:
        raise SystemExit(f"marks not placed: {missing}")
    hook = ("__device__ unsigned wkv_prof[64];\n#define WKV_MARK(i) do { "
            "const unsigned n_ = clock(); wkv_acc[i] += n_ - wkv_last; "
            "wkv_last = n_; } while (0)\n")
    text = replace(text, "namespace {\n\nconstexpr int HALF",
                   hook + "namespace {\n\nconstexpr int HALF")
    text += ('\nextern "C" int wkv_prof_read(unsigned* out) {\n'
             "  cudaMemcpyFromSymbol(out, wkv_prof, sizeof(unsigned) * 64);\n"
             "  return (int)cudaGetLastError();\n}\n")
    return text, phases


def build(texts: dict, tmp: Path) -> dict:
    from repro_torch.kernels import _build

    procs = {}
    for name, text in texts.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_scan.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.rwkv6_scan.restype = ci
        lib.rwkv6_scan_bwd.argtypes = [vp] * 15 + [ci] * 6 + [vp]
        lib.rwkv6_scan_bwd.restype = ci
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import rwkv6_scan as WKV

    source = (ROOT / "src/repro_torch/kernels/csrc" / CW.SOURCE).read_text()
    texts = {"base": source}
    for name, subs in ABLATIONS.items():
        text = source
        for old, new in subs:
            text = replace(text, old, new)
        texts[name] = text
    texts["sections"], phases = instrumented(source)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, T, H, dh = SHAPE
    D = H * dh
    big = torch.from_numpy(rng.standard_normal(
        (B, T, 3 * D), dtype=np.float32)).to(dev).to(torch.bfloat16)
    r, k, v = (big[..., x * D:(x + 1) * D].unflatten(-1, (H, dh))
               for x in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(
        np.log(1e-12), np.log(0.999), (B, T, H, dh))).astype(np.float32)
    ).to(dev)
    u = torch.from_numpy(rng.normal(0, 0.5, (H, dh)).astype(np.float32)
                         ).to(dev)
    dy = torch.from_numpy(rng.standard_normal((B, T, H, dh),
                                              dtype=np.float32)).to(dev)
    ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh), device=dev)

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, Path(tmp))
        real = CW._lib
        try:
            CW._lib = lambda: libs["base"]
            CW.launch(r, k, v, w, u, None, ckpt=ck)
            times = {}
            for turn in range(2):
                for name in ["base", *ABLATIONS]:
                    CW._lib = (lambda lib: lambda: lib)(libs[name])
                    times.setdefault(name, []).append(device_ms(
                        lambda: CW.launch_bwd(r, k, v, w, u, ck, dy, None)))
            print(json.dumps({"part": "ablations", "shape": list(SHAPE),
                              "ms": times}), flush=True)
            lib = libs["sections"]
            lib.wkv_prof_read.argtypes = [ctypes.c_void_p]
            CW._lib = lambda: lib
            CW.launch_bwd(r, k, v, w, u, ck, dy, None)
            torch.cuda.synchronize()
            buf = (ctypes.c_uint * 64)()
            lib.wkv_prof_read(ctypes.addressof(buf))
            total = buf[len(phases)]
            print(json.dumps({
                "part": "sections", "shape": list(SHAPE),
                "cta0_cycles": total,
                "cycles": {p: buf[i] for i, p in enumerate(phases)},
                "share": {p: round(buf[i] / total, 4)
                          for i, p in enumerate(phases)}}), flush=True)
        finally:
            CW._lib = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
