"""Fleet CLI — serve an emitted fleet over a socket, or replay against it.

The port of `python -m repro.serve`.  Every tenant runs on the current CUDA
device unless `--device` / `--devices` name another (`--device cpu` runs
the plain PyTorch versions); without a card the default raises.

    # stand the emit dir up as a network service (hot-reloads fleet.json);
    # --shards N runs N SO_REUSEPORT accept loops, --udp-port adds the
    # connectionless fire-and-forget ingest endpoint
    PYTHONPATH=src python -m repro_torch.serve serve --emit-dir artifacts \
        --port 7341 --shards 2 --udp-port 7342 --replicas 2 \
        --max-queue 4096 --watch

    # replay held-out sensor streams in-process (the classic mode; the
    # bare-flag legacy form `python -m repro_torch.serve --emit-dir ...` still
    # resolves here)
    PYTHONPATH=src python -m repro_torch.serve replay --emit-dir artifacts \
        --replay all --producers 4 --readings 1024 --deadline-ms 100

    # same replay, but through the wire against a running server;
    # --batch N ships N readings per SUBMIT_BATCH frame (protocol v2)
    PYTHONPATH=src python -m repro_torch.serve replay --emit-dir artifacts \
        --connect 127.0.0.1:7341 --replay all --batch 256

    # blast readings at the UDP ingest port, then bound the loss via the
    # server's TCP STATS counters
    PYTHONPATH=src python -m repro_torch.serve firehose --emit-dir artifacts \
        --connect 127.0.0.1:7341 --udp 127.0.0.1:7342 --readings 4096

Both replay modes load every tenant the emit dir's `fleet.json` manifest
names (emitted by `python -m repro_torch.compile.export` or the
reference's emitters), replay each tenant's held-out test split from N
concurrent producer threads, and print a per-tenant report: throughput,
p50/p99 request latency, SLO violations, admission sheds, and
bit-identity of the served labels against the offline
`CircuitProgram.predict` reference.  **Any label mismatch or dispatch
error exits nonzero on its own**; `--strict` additionally turns SLO
violations and sheds into a nonzero exit — the CI fleet smoke runs
exactly that.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
from pathlib import Path

import numpy as np

from repro_torch.serve.fleet import (DEFAULT_DEADLINE_MS, DEFAULT_MAX_BATCH,
                                     ClassifierFleet)

SUBCOMMANDS = ("serve", "replay", "firehose")


def _add_fleet_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--emit-dir", required=True,
                    help="directory holding fleet.json + program bundles")
    ap.add_argument("--device", default=None,
                    help="device for every tenant (default: the current "
                         "CUDA device; 'cpu' runs the plain versions)")
    ap.add_argument("--devices", default=None,
                    help="per-tenant pins, e.g. 'tnn_cardio=cuda:0,"
                         "tnn_breast_cancer=cpu' (overrides --device)")
    ap.add_argument("--max-batch", type=int, default=DEFAULT_MAX_BATCH)
    ap.add_argument("--deadline-ms", type=float, default=DEFAULT_DEADLINE_MS,
                    help="per-request latency budget (SLO)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engine replicas per tenant (default: manifest "
                         "hint, else 1)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission limit: shed submits beyond this queue "
                         "depth (default: never shed)")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-per-device dispatch workers: run N "
                         "subprocesses per device fed over shared-memory "
                         "reading planes (default: dispatch in-process)")
    ap.add_argument("--qos", default=None,
                    help="QoS classes: one of guaranteed|best_effort for "
                         "every tenant, or per-tenant pairs "
                         "'tnn_cardio=guaranteed,tnn_redwine=best_effort'")
    ap.add_argument("--rate-limit", default=None,
                    help="token-bucket admission rate (readings/s): one "
                         "float for every tenant, or per-tenant pairs "
                         "'tnn_cardio=5000'")
    ap.add_argument("--best-effort-backlog", type=int, default=None,
                    help="shed best_effort submissions once their device's "
                         "total backlog (queued + in flight) reaches this")
    ap.add_argument("--megakernel", action="store_true",
                    help="fused multi-tenant dispatch: every due tenant of "
                         "a device rides ONE multi-program kernel launch "
                         "per scheduler pass (in-process only)")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink replica pools from shed/queue/cost "
                         "pressure (bounds: --min-replicas/--max-replicas)")
    ap.add_argument("--autoscale-interval", type=float, default=1.0,
                    help="seconds between autoscaler rounds")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscale floor per tenant (default 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling per tenant (default: the "
                         "tenant's initial replica count)")


def _parse_args(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    # legacy spelling: `python -m repro_torch.serve --emit-dir ...` == replay
    if argv and argv[0].startswith("-"):
        argv = ["replay"] + argv
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("serve", help="serve the fleet over a TCP socket")
    _add_fleet_args(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7341)
    sp.add_argument("--shards", type=int, default=1,
                    help="SO_REUSEPORT accept loops (threads); connections "
                         "are kernel-balanced across them")
    sp.add_argument("--udp-port", type=int, default=None,
                    help="also listen for fire-and-forget SUBMIT[_BATCH] "
                         "datagrams on this UDP port")
    sp.add_argument("--watch", action="store_true",
                    help="watch fleet.json and hot-reload tenants")

    rp = sub.add_parser("replay", help="replay held-out streams and verify")
    _add_fleet_args(rp)
    rp.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="replay through a running server instead of "
                         "in-process")
    rp.add_argument("--replay", default="all",
                    help="comma list of tenant or dataset names (default: "
                         "every tenant with a dataset)")
    rp.add_argument("--producers", type=int, default=4,
                    help="concurrent submitter threads")
    rp.add_argument("--readings", type=int, default=1024,
                    help="readings replayed per tenant")
    rp.add_argument("--batch", type=int, default=1,
                    help="readings per SUBMIT_BATCH frame when replaying "
                         "through --connect (1 = classic per-reading "
                         "SUBMIT frames)")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--timeout", type=float, default=120.0,
                    help="overall completion timeout (seconds)")
    rp.add_argument("--strict", action="store_true",
                    help="also exit nonzero on any SLO miss or shed "
                         "(mismatches and errors always exit nonzero)")
    rp.add_argument("--out", default=None,
                    help="write the replay report as JSON here")

    fp = sub.add_parser("firehose", help="blast the UDP ingest endpoint and "
                                         "bound the loss via TCP stats")
    _add_fleet_args(fp)
    fp.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="the server's TCP address (for STATS counters)")
    fp.add_argument("--udp", required=True, metavar="HOST:PORT",
                    help="the server's UDP ingest address")
    fp.add_argument("--replay", default="all",
                    help="comma list of tenant or dataset names")
    fp.add_argument("--readings", type=int, default=4096,
                    help="readings blasted per tenant")
    fp.add_argument("--batch", type=int, default=64,
                    help="readings per SUBMIT_BATCH datagram")
    fp.add_argument("--seed", type=int, default=0)
    fp.add_argument("--timeout", type=float, default=30.0,
                    help="how long to wait for the received count to settle")
    fp.add_argument("--min-frac", type=float, default=0.5,
                    help="exit nonzero when fewer than this fraction of "
                         "blasted readings reached the server (UDP is "
                         "best-effort; loopback should deliver ~all)")
    fp.add_argument("--out", default=None,
                    help="write the firehose report as JSON here")
    return ap.parse_args(argv)


def _parse_devices(args) -> str | dict | None:
    if not args.devices:
        return args.device
    devices = {}
    for pair in args.devices.split(","):
        name, _, dev = pair.strip().partition("=")
        if not name or not dev:
            raise SystemExit(f"bad --devices entry {pair!r}; want "
                             f"'tenant=device'")
        devices[name] = dev
    return devices


def _scalar_or_map(raw: str | None, cast):
    """Parse 'value' or 'name=value,name=value' CLI spellings."""
    if raw is None:
        return None
    if "=" not in raw:
        return cast(raw)
    out = {}
    for pair in raw.split(","):
        name, _, val = pair.strip().partition("=")
        if not name or not val:
            raise SystemExit(f"bad per-tenant entry {pair!r}; want "
                             f"'tenant=value'")
        out[name] = cast(val)
    return out


def _build_fleet(args, live: bool = True) -> ClassifierFleet:
    """`live=False` builds a reference-only fleet (the --connect client
    path: offline programs + tenant metadata, no warmup jit, no replica
    pools spun hot, no scheduler threads)."""
    from repro_torch.serve.autoscale import AutoscaleConfig

    autoscale = (AutoscaleConfig() if live and getattr(args, "autoscale",
                                                       False) else None)
    return ClassifierFleet.from_emit_dir(
        args.emit_dir, device=_parse_devices(args),
        max_batch=args.max_batch, deadline_ms=args.deadline_ms,
        replicas=(args.replicas if live else 1), max_queue=args.max_queue,
        qos=_scalar_or_map(getattr(args, "qos", None), str),
        rate_limit_rps=_scalar_or_map(getattr(args, "rate_limit", None),
                                      float),
        min_replicas=getattr(args, "min_replicas", None),
        max_replicas=getattr(args, "max_replicas", None),
        workers=(getattr(args, "workers", None) if live else None),
        best_effort_backlog=getattr(args, "best_effort_backlog", None),
        autoscale=autoscale,
        autoscale_interval_s=getattr(args, "autoscale_interval", 1.0),
        megakernel=(getattr(args, "megakernel", False) if live else False),
        warmup=live, autostart=live)


def _build_streams(fleet: ClassifierFleet, selected: list[str],
                   n_readings: int, seed: int) -> dict[str, np.ndarray]:
    from repro_torch.data.tabular import make_dataset

    streams = {}
    for i, name in enumerate(selected):
        dataset = fleet._tenant(name).spec.dataset
        if dataset is None:
            raise SystemExit(f"tenant {name} has no dataset in the "
                             "manifest — nothing to replay against")
        ds = make_dataset(dataset)
        rng = np.random.default_rng(seed + i)
        idx = rng.integers(0, ds.x_test.shape[0], size=n_readings)
        streams[name] = ds.x_test[idx]
    return streams


def _select_tenants(fleet: ClassifierFleet, replay: str) -> list[str]:
    rows = {name: fleet._tenant(name).spec for name in fleet.tenants}
    if replay == "all":
        selected = [n for n, s in rows.items() if s.dataset]
        skipped = [n for n, s in rows.items() if not s.dataset]
        if skipped:
            print(f"[fleet] skipping tenants without a dataset: "
                  f"{', '.join(sorted(skipped))}")
    else:
        want = [w.strip() for w in replay.split(",") if w.strip()]
        selected = [n for n, s in rows.items()
                    if n in want or (s.dataset in want)]
        missing = [w for w in want
                   if not any(n == w or rows[n].dataset == w
                              for n in rows)]
        if missing:
            raise SystemExit(f"--replay names not served by this fleet: "
                             f"{', '.join(missing)}")
    if not selected:
        raise SystemExit("nothing to replay (no tenant with a dataset "
                         "matched --replay)")
    return sorted(selected)


def _interleave(streams: dict[str, np.ndarray], batch: int = 1):
    """(sorted tenant order, [(tenant, start)] interleaved across tenants)
    — so every producer hits every tenant rather than draining them one
    at a time.  With `batch > 1` each task is a chunk start; the submit
    callback owns rows [start, start+batch)."""
    order = sorted(streams)
    tasks = []
    max_len = max(x.shape[0] for x in streams.values())
    for i in range(0, max_len, batch):
        for name in order:
            if i < streams[name].shape[0]:
                tasks.append((name, i))
    return order, tasks


def _run_producers(tasks, producers: int, submit_one, timeout: float) -> None:
    """Drive `submit_one(tenant, row_index)` from N interleaved threads;
    surface producer exceptions instead of hanging the join."""
    errors: list[str] = []

    def produce(worker: int) -> None:
        try:
            for name, i in tasks[worker::producers]:
                submit_one(name, i)
        except Exception as exc:
            errors.append(f"producer {worker}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=produce, args=(w,), daemon=True)
               for w in range(max(1, producers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise TimeoutError(f"producers still submitting after {timeout}s: "
                           f"{', '.join(stuck)}")
    if errors:
        raise RuntimeError("; ".join(errors))


def replay_fleet(fleet: ClassifierFleet, streams: dict[str, np.ndarray],
                 producers: int = 4, timeout: float = 120.0) -> dict:
    """Submit every stream row from `producers` interleaved threads; wait;
    verify served labels bit-identical to offline `CircuitProgram.predict`.

    When the fleet has admission control armed (`max_queue`), a shed
    producer honors the `retry_after_ms` hint and resubmits; sheds are
    counted per tenant.
    """
    import time as _time

    from repro_torch.serve.fleet import FleetOverloadError

    order, tasks = _interleave(streams)
    results: dict[str, list] = {n: [None] * streams[n].shape[0]
                                for n in order}
    shed_counts = {n: 0 for n in order}
    shed_lock = threading.Lock()

    def submit_one(name: str, i: int) -> None:
        while True:
            try:
                results[name][i] = fleet.submit(name, streams[name][i])
                return
            except FleetOverloadError as exc:
                with shed_lock:
                    shed_counts[name] += 1
                _time.sleep(min(exc.retry_after_ms, 1000.0) * 1e-3)

    _run_producers(tasks, producers, submit_one, timeout)

    report = {"tenants": {}, "producers": producers, "transport": "inproc"}
    ok = True
    for name in order:
        reqs = results[name]
        for r in reqs:
            r.result(timeout)                 # waits; raises on error
        labels = np.array([r.label for r in reqs], dtype=np.int32)
        prog = fleet._tenant(name).engine.program
        ref = prog.predict(streams[name]).astype(np.int32)
        match = bool((labels == ref).all())
        ok &= match
        misses = sum(r.slo_miss for r in reqs)
        worst = max((r.latency_ms for r in reqs), default=0.0)
        s = fleet._tenant(name).stats.summary()
        report["tenants"][name] = {
            "device": fleet.tenant_device(name),
            "replicas": fleet.tenant_replicas(name),
            "dataset": fleet._tenant(name).spec.dataset,
            "readings": len(reqs),
            "labels_match_offline": match,
            "slo_miss": int(misses),
            "n_shed": shed_counts[name],
            "worst_latency_ms": round(worst, 3),
            **s,
        }
    report["fleet"] = fleet.stats.summary()
    if fleet.megakernel:
        report["megakernel"] = fleet.stats_summary().get("megakernel")
    report["errors"] = list(fleet.errors)
    report["labels_match_offline"] = ok
    return report


def replay_client(client, fleet: ClassifierFleet,
                  streams: dict[str, np.ndarray], producers: int = 4,
                  timeout: float = 120.0, batch: int = 1) -> dict:
    """`replay_fleet`, but every reading crosses the socket transport.

    `fleet` here is the *local* reference (offline programs + tenant
    metadata — it may be built with `warmup=False, autostart=False`);
    nothing is submitted to it.  Producers are submit-only so batching,
    not round-trips, sets the pace; `batch > 1` ships chunks of that many
    rows per `SUBMIT_BATCH` frame via `submit_many` (the v2 fast path).
    Sheds are retried in the collection pass with the server's
    `retry_after_ms` hint and counted.
    """
    import time as _time

    from repro_torch.serve.client import FleetShedError

    order, tasks = _interleave(streams, batch)
    results: dict[str, list] = {n: [None] * streams[n].shape[0]
                                for n in order}
    shed_counts = {n: 0 for n in order}

    def submit_one(name: str, s: int) -> None:
        deadline_ms = fleet._tenant(name).spec.deadline_ms
        if batch == 1:
            results[name][s] = client.submit(name, streams[name][s],
                                             deadline_ms=deadline_ms)
        else:
            e = min(s + batch, streams[name].shape[0])
            results[name][s:e] = client.submit_many(
                name, streams[name][s:e], deadline_ms)

    _run_producers(tasks, producers, submit_one, timeout)

    for name in order:          # collect; a shed row backs off and retries
        deadline_ms = fleet._tenant(name).spec.deadline_ms
        for i, pend in enumerate(results[name]):
            while True:
                try:
                    pend.result(timeout)
                except FleetShedError as exc:
                    shed_counts[name] += 1
                    _time.sleep(min(exc.retry_after_ms, 1000.0) * 1e-3)
                    pend = client.submit(name, streams[name][i],
                                         deadline_ms=deadline_ms)
                    continue
                results[name][i] = pend
                break

    server_stats = client.stats()
    report = {"tenants": {}, "producers": producers, "transport": "socket",
              "batch": batch, "protocol_version": client.protocol_version}
    ok = True
    total_miss = total = 0
    for name in order:
        pends = results[name]
        labels = np.array([p.label for p in pends], dtype=np.int32)
        prog = fleet._tenant(name).engine.program
        ref = prog.predict(streams[name]).astype(np.int32)
        match = bool((labels == ref).all())
        ok &= match
        deadline_ms = fleet._tenant(name).spec.deadline_ms
        lat = np.array([p.latency_ms for p in pends])
        misses = int((lat > deadline_ms).sum())
        total_miss += misses
        total += len(pends)
        remote = server_stats["tenants"].get(name, {})
        report["tenants"][name] = {
            "device": remote.get("device", remote.get("backend")),
            "replicas": len(remote.get("replicas", [])) or None,
            "dataset": fleet._tenant(name).spec.dataset,
            "readings": len(pends),
            "labels_match_offline": match,
            "slo_miss": misses,
            "n_shed": shed_counts[name],
            "worst_latency_ms": round(float(lat.max()), 3),
            **{k: remote[k] for k in ("n_readings", "n_batches",
                                      "readings_per_s", "req_p50_ms",
                                      "req_p99_ms", "n_slo_miss")
               if k in remote},
        }
    sf = server_stats["fleet"]
    # gate (n_slo_miss / n_shed) on *this replay's* traffic — the server's
    # lifetime counters may carry misses/sheds from earlier clients; its
    # throughput/latency figures stay as informational context
    report["fleet"] = {
        **sf,
        "n_readings": total,
        "n_slo_miss": total_miss,
        "n_shed": sum(shed_counts.values()),
    }
    report["server_fleet_lifetime"] = sf
    report["errors"] = []
    report["labels_match_offline"] = ok
    return report


def exit_code(report: dict, strict: bool) -> int:
    """1 on any mismatch or dispatch error — strict or not; `strict`
    additionally fails on SLO misses and admission sheds."""
    bad = (not report["labels_match_offline"]) or bool(report["errors"])
    if strict:
        bad = (bad or report["fleet"].get("n_slo_miss", 0) > 0
               or report["fleet"].get("n_shed", 0) > 0
               or any(t.get("n_shed", 0) > 0
                      for t in report["tenants"].values()))
    return 1 if bad else 0


def _print_report(report: dict) -> None:
    for name, row in report["tenants"].items():
        verdict = "ok" if row["labels_match_offline"] else "MISMATCH"
        print(f"[{name}] device={row['device']} "
              f"replicas={row.get('replicas')} "
              f"{row['readings']} readings, "
              f"req p50 {row.get('req_p50_ms', 0):.2f} ms "
              f"p99 {row.get('req_p99_ms', 0):.2f} ms, "
              f"slo_miss={row['slo_miss']} "
              f"shed={row.get('n_shed', 0)} labels={verdict}")
    f = report["fleet"]
    print(f"[fleet/{report['transport']}] total {f['n_readings']} readings, "
          f"{f['n_batches']} dispatches, slo_miss={f['n_slo_miss']}, "
          f"shed={f.get('n_shed', 0)}, req p99 {f['req_p99_ms']:.2f} ms")
    if report["errors"]:
        print(f"[fleet] dispatch errors: {report['errors']}")


def _main_serve(args) -> int:
    from repro_torch.serve.server import serve_forever

    fleet = _build_fleet(args)
    serve_forever(fleet, args.host, args.port, shards=args.shards,
                  udp_port=args.udp_port, watch_manifest=args.watch)
    return 0


def _main_firehose(args) -> int:
    import time as _time

    from repro_torch.serve.client import FleetClient, UdpSwarmSender

    fleet = _build_fleet(args, live=False)
    selected = _select_tenants(fleet, args.replay)
    streams = _build_streams(fleet, selected, args.readings, args.seed)
    host, _, port = args.connect.rpartition(":")
    uhost, _, uport = args.udp.rpartition(":")
    with FleetClient(host or "127.0.0.1", int(port)) as client:
        before = client.stats()["transport"]["udp"]
        sender = UdpSwarmSender(uhost or "127.0.0.1", int(uport))
        t0 = _time.perf_counter()
        sent = sum(
            sender.send_many(name, streams[name][s:s + args.batch])
            for name in selected
            for s in range(0, streams[name].shape[0], args.batch))
        send_s = _time.perf_counter() - t0
        sender.close()
        # wait for the received count to stop moving (drain), then read it
        deadline = _time.monotonic() + args.timeout
        last = -1
        while _time.monotonic() < deadline:
            udp = client.stats()["transport"]["udp"]
            got = udp["n_readings"] - before["n_readings"]
            if got >= sent or (got == last and got > 0):
                break
            last = got
            _time.sleep(0.25)
        udp = client.stats()["transport"]["udp"]
    received = udp["n_readings"] - before["n_readings"]
    frac = received / max(1, sent)
    report = {
        "transport": "udp", "tenants": sorted(selected),
        "readings_sent": int(sent), "readings_received": int(received),
        "received_frac": round(frac, 4),
        "send_rate_per_s": round(sent / max(send_s, 1e-9), 1),
        "n_admitted": udp["n_admitted"] - before["n_admitted"],
        "n_shed": udp["n_shed"] - before["n_shed"],
        "n_errors": udp["n_errors"] - before["n_errors"],
    }
    print(f"[firehose] sent {sent} readings "
          f"({report['send_rate_per_s']:.0f}/s), server received "
          f"{received} ({frac:.1%}), admitted {report['n_admitted']}, "
          f"shed {report['n_shed']}, errors {report['n_errors']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2,
                                             sort_keys=True) + "\n")
        print(f"wrote {args.out}")
    if frac < args.min_frac:
        print(f"[firehose] FAIL: received fraction {frac:.1%} below "
              f"--min-frac {args.min_frac:.1%}")
        return 1
    return 0


def _main_replay(args) -> int:
    if args.batch > 1 and not args.connect:
        raise SystemExit("--batch frames only exist on the wire; "
                         "pair it with --connect")
    fleet = _build_fleet(args, live=not args.connect)
    client = None
    try:
        selected = _select_tenants(fleet, args.replay)
        streams = _build_streams(fleet, selected, args.readings, args.seed)
        mode = f"socket {args.connect}" if args.connect else "in-process"
        print(f"[fleet] {len(fleet.tenants)} tenant(s) loaded, replaying "
              f"{', '.join(selected)} x {args.readings} readings from "
              f"{args.producers} producers (deadline {args.deadline_ms} ms, "
              f"{mode})")
        if args.connect:
            from repro_torch.serve.client import FleetClient

            host, _, port = args.connect.rpartition(":")
            client = FleetClient(host or "127.0.0.1", int(port))
            report = replay_client(client, fleet, streams,
                                   producers=args.producers,
                                   timeout=args.timeout, batch=args.batch)
        else:
            report = replay_fleet(fleet, streams, producers=args.producers,
                                  timeout=args.timeout)
    finally:
        if client is not None:
            client.close()
        fleet.shutdown(drain=True)

    _print_report(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2, sort_keys=True)
                                  + "\n")
        print(f"wrote {args.out}")
    return exit_code(report, args.strict)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.command == "serve":
        return _main_serve(args)
    if args.command == "firehose":
        return _main_firehose(args)
    return _main_replay(args)


if __name__ == "__main__":
    sys.exit(main())
