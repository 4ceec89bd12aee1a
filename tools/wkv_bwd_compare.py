#!/usr/bin/env python3
"""The WKV-6 backward kernel against an earlier build of it, on one card.

    python3 tools/wkv_bwd_compare.py --parent-src FILE [--reps N]

FILE is an earlier `csrc/rwkv6_scan.cu` whose backward entry point still
takes a global scratch of CK states a row (`hist`: the one-CTA-a-row
kernel before the cluster design), e.g. `git show
f128a25:src/repro_torch/kernels/csrc/rwkv6_scan.cu > FILE`.  The script
builds FILE with nvcc into a temporary directory outside the checkout,
builds this checkout's source as the port does, and at each shape below
runs both backward kernels on the same operands (the model's strided
bf16 views, decays log-uniform down to 1e-12, u shared by the batch,
checkpoints from this checkout's forward) in turns -- earlier, this,
this, earlier -- timing each with CUDA events (median of `--reps`
launches after a spin kernel, the kernel alone).  Shapes `(B, T, H,
dh)`: rwkv6-7b's training microbatch (2, 256, 64, 64), one row (1, 256,
1, 64), an odd head count with T off the chunk (1, 257, 3, 64), and a
larger microbatch (16, 256, 64, 64).

Prints one JSON line per shape (`ms` of both kernels in turn order,
their largest difference in any gradient, the bound from
`roofline.kernel_model`), then the new kernel's geometry on this card
(`cuda_rwkv6_scan.card_geometry`) and the card's name and power limit.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SHAPES = ((2, 256, 64, 64), (1, 256, 1, 64), (1, 257, 3, 64),
          (16, 256, 64, 64))
SEED = 0


def build_parent(src: Path, out_dir: Path) -> ctypes.CDLL:
    """The earlier source as a library with its backward entry point's
    signature (a `hist` pointer after ds0, no staging flag)."""
    from repro_torch.kernels import _build

    lib_path = out_dir / "parent_rwkv6_scan.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_bwd.argtypes = [vp] * 16 + [ci] * 5 + [vp]
    lib.rwkv6_scan_bwd.restype = ci
    return lib


def parent_bwd(lib, r, k, v, w, u, ck, dy):
    """The earlier kernel's launch, as its wrapper made it (no state
    gradient)."""
    import torch

    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels.rwkv6_scan import CK

    B, T, H, dh = r.shape
    p = CW.plan_bwd(r, k, v, w, u)
    dev = r.device
    shape = (B, T, H, dh)
    dr, dk, dv = (torch.empty(shape, dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    du = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    hist = torch.empty((B * H, CK * dh * dh), dtype=torch.float32,
                       device=dev)
    steps = (ctypes.c_longlong * 9)(*p.steps)
    err = lib.rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), ck.data_ptr(), dy.data_ptr(), None, dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), hist.data_ptr(), ctypes.addressof(steps), B * H, H,
        T, dh, int(p.bf16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier rwkv6_scan_bwd failed: CUDA error "
                           f"{err}")
    return dr, dk, dv, dw, du, ds0


def operands(rng, dev, B, T, H, dh):
    """The model's layout: r, k, v bf16 slices of one projection output,
    w float32 decays, u (H, dh); dy float32."""
    import torch

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
    return r, k, v, w, u, dy


def device_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.roofline.kernel_model import wkv_bwd_bound_ms

    dev = torch.device("cuda")
    _build.build([CW.SOURCE])
    with tempfile.TemporaryDirectory() as tmp:
        parent = build_parent(args.parent_src.resolve(), Path(tmp))
        rng = np.random.default_rng(SEED)
        for B, T, H, dh in SHAPES:
            r, k, v, w, u, dy = operands(rng, dev, B, T, H, dh)
            ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh),
                             dtype=torch.float32, device=dev)
            CW.launch(r, k, v, w, u, None, ckpt=ck)
            new = CW.launch_bwd(r, k, v, w, u, ck, dy, None)
            old = parent_bwd(parent, r, k, v, w, u, ck, dy)
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(new, old))
            run = {"parent": lambda: parent_bwd(parent, r, k, v, w, u, ck,
                                                dy),
                   "new": lambda: CW.launch_bwd(r, k, v, w, u, ck, dy,
                                                None)}
            turns = [(name, device_ms(run[name], args.reps))
                     for name in ("parent", "new", "new", "parent")]
            bound, by = wkv_bwd_bound_ms(B * H, T, dh, False, False,
                                         r.element_size(), H)
            p = CW.plan_bwd(r, k, v, w, u, dy, ck)
            print(json.dumps({
                "shape": [B, T, H, dh], "x": "bfloat16", "turns": turns,
                "parent_ms": [t for n, t in turns if n == "parent"],
                "new_ms": [t for n, t in turns if n == "new"],
                "max_abs_diff": diff, "bound_ms": bound, "bound_by": by,
                "ctas": p.blocks, "design": p.design}), flush=True)
            del r, k, v, w, u, dy, ck, new, old
    torch.cuda.synchronize()
    print(json.dumps({"geometry": {
        f"dh{dh}_{'bf16' if bf16 else 'f32'}": CW.card_geometry(dh, bf16)
        for dh in CW.HEAD_SIZES for bf16 in (True, False)}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
