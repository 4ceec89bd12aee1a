"""Serving a fleet, end to end: emit -> manifest -> serve -> replay.

Trains quick exact TNNs on two Table-2 datasets, emits each as a servable
artifact bundle (Verilog + EGFET report + sha256-checked program npz,
registered in the emit dir's fleet.json manifest), then exercises both
halves of the unified `repro_torch.serve` stack:

  1. **in-process** — stands the directory up as a multi-tenant
     `ClassifierFleet` (2 engine replicas per tenant, least-loaded
     routing) and replays both held-out test streams concurrently through
     the deadline-driven micro-batching scheduler;
  2. **over the wire** — starts the asyncio socket server on the same
     fleet and replays again through `FleetClient`, every reading crossing
     the length-prefixed binary protocol, then hot-reloads the manifest
     through the RELOAD round-trip.

The same flows are available as CLIs against any emit dir — including
`repro_torch.evolve --emit-dir` campaign output:

    PYTHONPATH=src python -m repro_torch.serve serve  --emit-dir artifacts \
        --watch
    PYTHONPATH=src python -m repro_torch.serve replay --emit-dir artifacts \
        --connect 127.0.0.1:7341 --replay all

The port of `examples/serve_fleet.py`: training and serving run on
`--device` (default: the current CUDA device; `cpu` runs the plain
PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/serve_fleet.py [out_dir]
          [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.compile import lower_classifier, write_artifacts
from repro_torch.core import tnn as T
from repro_torch.data.tabular import make_dataset
from repro_torch.serve import ClassifierFleet
from repro_torch.serve.__main__ import replay_client, replay_fleet
from repro_torch.serve.client import FleetClient
from repro_torch.serve.server import FleetServer

DATASETS = ("cardio", "breast_cancer")


def main(out_dir: str = "artifacts", device=None) -> dict:
    dev = resolve_device(device)
    # emit: one servable bundle per tenant, all registered in fleet.json
    streams = {}
    for dataset in DATASETS:
        ds = make_dataset(dataset)
        tnn = T.train_tnn(ds, T.TNNTrainConfig(
            n_hidden=ds.spec.topology[1], epochs=6, lr=1e-2), device=dev)
        cc = lower_classifier(tnn, *T.exact_netlists(tnn))
        paths = write_artifacts(cc, out_dir, base=f"tnn_{dataset}",
                                dataset=dataset, replicas=2)
        streams[f"tnn_{dataset}"] = np.tile(
            ds.x_test, (max(1, 1024 // ds.x_test.shape[0] + 1), 1))[:1024]
        print(f"[emit] tnn_{dataset}: acc={tnn.test_acc:.3f} "
              f"gates={cc.ir.n_gates} -> {paths['program']}")

    # serve: the manifest is the fleet (replica hints come from the rows)
    # 500 ms budget: generous enough that the socket replay's submission
    # ramp (per-reading frames from Python producers) stays inside SLO
    fleet = ClassifierFleet.from_emit_dir(out_dir, device=dev,
                                          max_batch=256, deadline_ms=500.0)
    server = FleetServer(fleet, watch_manifest=True)
    try:
        report = replay_fleet(fleet, streams, producers=4)
        for name, row in report["tenants"].items():
            print(f"[serve/inproc] {name}: {row['n_readings']} readings on "
                  f"{row['replicas']} replicas, "
                  f"{row['readings_per_s']:.0f} readings/s, req p99 "
                  f"{row['req_p99_ms']:.2f} ms, slo_miss={row['slo_miss']}, "
                  f"labels_match={row['labels_match_offline']}")
        assert report["labels_match_offline"], "fleet diverged from offline"

        # the same replay, through the socket transport
        host, port = server.start_background()
        with FleetClient(host, port) as client:
            wire = replay_client(client, fleet, streams, producers=4)
            for name, row in wire["tenants"].items():
                print(f"[serve/socket] {name}: {row['readings']} readings, "
                      f"req p99 {row.get('req_p99_ms', 0):.2f} ms, "
                      f"slo_miss={row['slo_miss']}, "
                      f"shed={row.get('n_shed', 0)}, "
                      f"labels_match={row['labels_match_offline']}")
            assert wire["labels_match_offline"], "socket diverged from offline"
            actions = client.reload()       # manifest hot-reload round-trip
            print(f"[serve/socket] manifest gen {actions['generation']}: "
                  f"nothing to move ({actions['added'] or '-'} added)")
    finally:
        server.stop()
        fleet.shutdown(drain=True)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="artifacts")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current CUDA device) or cpu")
    a = ap.parse_args()
    main(a.out_dir, a.device)
