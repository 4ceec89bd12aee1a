#!/usr/bin/env python3
"""The bound of the serve bench's megakernel launch, computed on the CPU.

    PYTHONPATH=src python tools/serve_fleet_bound.py [--frame N]

Builds the four tenants of `benchmarks_torch.serve_throughput`'s
`serve_megakernel` rows as the bench does (`get_trained_tnn` at the quick
budgets, the exact netlists, `lower_classifier`; trained here on the CPU),
and prices one `fleet_eval_words` launch of all four at `--frame`
readings each (the bench's `MEGAKERNEL_FRAME`, 1,024: 32 words) with
`roofline.kernel_model.fleet_roofline`: the padded launch's bytes over
3.35 TB/s against its gate-word operations, and its chain of dependent
levels.  Prints one JSON line: each tenant's shape, the padded launch's
bound and what sets it, the chain bound and the padding efficiency.
Nothing here runs on or for a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    from benchmarks_torch.common import get_trained_tnn
    from benchmarks_torch.serve_throughput import (MEGAKERNEL_FRAME,
                                                   MEGAKERNEL_TENANTS)
    from repro_torch.compile.ir import lower_classifier
    from repro_torch.core.tnn import exact_netlists
    from repro_torch.roofline.kernel_model import (CircuitShape,
                                                   fleet_roofline)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frame", type=int, default=MEGAKERNEL_FRAME)
    args = ap.parse_args()
    W = -(-args.frame // 32)
    tenants, shapes = {}, []
    for dataset in MEGAKERNEL_TENANTS:
        _, tnn = get_trained_tnn(dataset, device="cpu")
        ir = lower_classifier(tnn, *exact_netlists(tnn)).ir
        shapes.append(CircuitShape(P=1, G=ir.n_gates, n_in=ir.n_inputs, W=W,
                                   n_out=ir.n_outputs, shared_words=False,
                                   depth=ir.depth))
        tenants[dataset] = {"n_in": ir.n_inputs, "gates": ir.n_gates,
                            "n_out": ir.n_outputs, "depth": ir.depth}
    rl, eff = fleet_roofline(shapes)
    print(json.dumps({"frame": args.frame, "W": W, "tenants": tenants,
                      "bound_ms": rl.bound_ms, "bound_by": rl.dominant,
                      "bytes": rl.bytes_accessed, "ops": rl.ops,
                      "chain_ms": rl.chain_s * 1e3,
                      "padding_efficiency": eff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
