"""Command line for batched greedy decoding through the `ServingEngine`.

    python -m repro_torch.launch.serve --arch llama3.2-1b --no-reduced \
        --quant ternary_packed --requests 8 --max-new 16
    python -m repro_torch.launch.serve --arch rwkv6-7b --no-reduced \
        --quant dense

Runs on the current CUDA device unless `--device cpu` is given.  For
`ternary_packed` the weights come from `models.params.seeded_params`
(numpy seed `--seed`), which quantizes and packs each layer's projection,
so the codes are not the all-zero init of `init_params`; otherwise they
are the reference's init, drawn by `init_params` on the device from
`--seed` (a host draw of rwkv6-7b's 7.6 B weights would take minutes).
`--reduced` (the default, as in the reference's `repro.launch.serve`)
serves the small same-family config; `--no-reduced` serves the full
width.  RWKV-6 serves dense only (`--quant dense`) and ignores
`--cache-len`.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.params import init_params, param_count, \
    seeded_params
from repro_torch.serve.lm_engine import Request, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--quant", default=None,
                    choices=["dense", "ternary", "ternary_packed"])
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
    params = (seeded_params if cfg.quant == "ternary_packed"
              else init_params)(cfg, args.seed, args.device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           cache_len=args.cache_len, device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
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
