"""Compile-and-export CLI: train -> compile -> emit RTL -> verify -> serve.

The port's whole path from sensor floats to served labels, with no file
the reference wrote: trains an exact TNN on one Table-2 dataset on the
device, lowers it to one `CircuitIR`, writes the structural Verilog, the
EGFET report, the servable bundle and its `fleet.json` row, re-evaluates
the emitted RTL with the independent `vread` reader against the compiled
program on the device, and serves a sensor stream through
`CircuitServingEngine`, whose labels must equal the circuit-accurate path
(`core.tnn.predict_with_circuits`).  Any disagreement exits non-zero.

    PYTHONPATH=src python -m repro_torch.compile.export [dataset] [out_dir]
        [--device cpu]

It runs on the current CUDA device, and raises without one unless
`--device cpu` asks for the plain PyTorch versions.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.compile.ir import lower_classifier
from repro_torch.compile.program import CircuitProgram
from repro_torch.compile.verilog import egfet_report, write_artifacts
from repro_torch.compile.vread import VerilogDesign, eval_classifier_verilog
from repro_torch.core import tnn as T
from repro_torch.core.ternary import abc_binarize
from repro_torch.data.tabular import make_dataset
from repro_torch.device import resolve_device
from repro_torch.serve.engine import CircuitServingEngine


def main(dataset: str = "breast_cancer", out_dir: str = "artifacts",
         epochs: int = 6, n_verify: int = 2048, n_serve: int = 1024,
         device=None) -> dict:
    dev = resolve_device(device)
    ds = make_dataset(dataset)
    tnn = T.train_tnn(ds, T.TNNTrainConfig(
        n_hidden=ds.spec.topology[1], epochs=epochs, lr=1e-2), device=dev)
    hidden_nls, out_nls = T.exact_netlists(tnn)
    cc = lower_classifier(tnn, hidden_nls, out_nls)
    paths = write_artifacts(cc, out_dir, base=f"tnn_{dataset}",
                            dataset=dataset)
    report = egfet_report(cc)
    print(f"[compile] {dataset}: acc={tnn.test_acc:.3f} "
          f"gates={cc.ir.n_gates} depth={cc.ir.depth} "
          f"area={report['total_area_mm2']:.2f}mm^2 "
          f"power={report['total_power_mw']:.3f}mW "
          f"({report['power_source']})")
    print(f"[emit] {paths['verilog']}  {paths['report']}")
    print(f"[emit] tenant tnn_{dataset} -> {paths['manifest']} "
          f"(serve with: python -m repro_torch.serve --emit-dir {out_dir})")

    # independent RTL re-evaluation vs the compiled program on the device
    rng = np.random.default_rng(0)
    xbits = rng.integers(0, 2, size=(n_verify, cc.n_features)
                         ).astype(np.uint8)
    prog = CircuitProgram.from_classifier(cc, device=dev)
    with open(paths["verilog"]) as f:
        design = VerilogDesign.parse(f.read())
    rtl = eval_classifier_verilog(design, xbits)
    if not (rtl == prog.predict_bits(xbits)).all():
        raise SystemExit("emitted RTL disagrees with compiled program")
    print(f"[verify] RTL == device program on {n_verify} random vectors "
          f"({dev})")

    # serving: classify a sensor stream, check it, report throughput
    engine = CircuitServingEngine(prog, max_batch=256)
    engine.warmup()
    reps = -(-n_serve // ds.x_test.shape[0])
    stream = np.tile(ds.x_test, (reps, 1))[:n_serve]
    labels = engine.classify_stream(stream)
    xb_stream = abc_binarize(stream, tnn.thresholds, device=dev)
    ref = T.predict_with_circuits(tnn, xb_stream.cpu().numpy(), hidden_nls,
                                  out_nls, device=dev)
    if not (labels == ref).all():
        raise SystemExit("serving labels disagree with reference path")
    s = engine.stats.summary()
    print(f"[serve] {s['n_readings']} readings in {s['n_batches']} batches: "
          f"{s['readings_per_s']:.0f} readings/s "
          f"(p50 {s['p50_ms']:.2f} ms/batch, {dev})")
    return {"tnn": tnn, "classifier": cc, "report": report, "paths": paths,
            "serve": s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="train -> lower -> emit Verilog -> read back -> serve")
    ap.add_argument("dataset", nargs="?", default="breast_cancer")
    ap.add_argument("out_dir", nargs="?", default="artifacts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    main(args.dataset, args.out_dir, device=args.device)
