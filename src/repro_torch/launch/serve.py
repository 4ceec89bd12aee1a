"""Command line for batched greedy decoding through the `ServingEngine`.

    python -m repro_torch.launch.serve --arch llama3.2-1b --no-reduced \
        --quant ternary_packed --requests 8 --max-new 16
    python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu \
        --reduced
    python -m repro_torch.launch.serve --arch rwkv6-7b --no-reduced \
        --quant dense

`--arch` takes any of the reference's ten archs (`configs.ARCHS`).  Runs
on the current CUDA device unless `--device cpu` is given.  Weights are
`models.params.serving_params` from `--seed`: the reference's init drawn
on the device and, for `ternary_packed`, each projection quantized and
packed there, so the codes are not the all-zero init.  `--reduced` (the
default, as in the reference's `repro.launch.serve`) serves the small
same-family config; `--no-reduced` serves the full width.
`--kv-cache-dtype float8_e4m3fn` stores the KV cache in fp8 (the config's
own field).  RWKV-6 and the
hybrid (hymba) serve dense only (`--quant dense`; any other raises
`ValueError`); RWKV-6 ignores `--cache-len`.  A VLM's prompts cover its
`n_vision_tokens` stub positions, so they are at least that long; a
prompt longer than a sliding window is cut to a multiple of it, the only
length whose rolling cache a prefill can fill (in the reference too).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.params import param_count, serving_params
from repro_torch.serve.lm_engine import Request, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCHS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--quant", default=None,
                    choices=["dense", "ternary", "ternary_packed"])
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=["compute", "float8_e4m3fn"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant:
        cfg = cfg.replace(quant=args.quant)
    if args.kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    params = serving_params(cfg, args.seed, args.device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           cache_len=args.cache_len, device=args.device)

    rng = np.random.default_rng(args.seed)
    least = cfg.n_vision_tokens if cfg.frontend == "vision" else 0
    reqs = []
    for i in range(args.requests):
        plen = least + int(rng.integers(4, 12))
        if cfg.swa_window and plen > cfg.swa_window:
            plen -= plen % cfg.swa_window     # what a rolling prefill takes
        reqs.append(Request(
            uid=i, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
            max_new_tokens=args.max_new))
    t0 = time.monotonic()
    out = engine.run(reqs)
    dt = time.monotonic() - t0
    total_new = sum(len(r.output) for r in out)
    print(f"{param_count(cfg)/1e6:.1f}M params ({cfg.quant}) on "
          f"{engine.device} | {len(out)} requests, {total_new} tokens in "
          f"{dt:.1f}s ({total_new/dt:.1f} tok/s)")
    print(json.dumps(engine.stats.summary()))
    for r in out[:3]:
        print(json.dumps({"uid": r.uid, "prompt": r.prompt,
                          "output": r.output}))


if __name__ == "__main__":
    main()
