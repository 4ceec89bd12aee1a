"""Sensor-stream serving throughput: single engine + multi-tenant fleet.

The port of `benchmarks/serve_throughput.py`, on `device` (None: the
current CUDA device).  The port has no backend names, so every row's
``backend`` key of the reference is ``device`` here (the tenant's device:
``cuda:0`` or ``cpu``); every other key and bench name is the reference's.

Single-engine section (``serve``): the cardio exact TNN (the paper's
mid-size Table-2 design) compiled to a `CircuitProgram` on `device`,
end-to-end engine throughput — raw readings in, class labels out,
including ABC binarization, bit-packing and decode — at batch sizes
{1, 64, 1024}, with a CPU row (the plain PyTorch walk) at the largest
batch in the place of the reference's numpy row.

Fleet section (``serve_fleet``): a 2-tenant `ClassifierFleet` (cardio +
breast_cancer) replays concurrent held-out streams from 4 producer threads
through the deadline-driven micro-batching scheduler.

Socket section (``serve_socket``, ``serve_socket_unary``): the same
replay with every reading over the length-prefixed TCP transport
(`serve/server.py` + `serve/client.py`), 256 readings a `SUBMIT_BATCH`
frame, and the one-frame-per-reading path.

Workers section (``serve_workers``): a 4-tenant fleet with `workers=2`
spawned processes on `device` (the reference pins two of its tenants to
numpy; here all four run on `device`), fed whole 2048-reading
`submit_many` frames, every label checked against the offline program.

Megakernel section (``serve_megakernel``): the same 4 tenants replayed
per-tenant (one launch a tenant batch) and with `megakernel=True` (every
due tenant in one `fleet_eval_words` launch a scheduler pass), labels
bit-checked both ways; the megakernel rows record the fused launches and
the most tenants one launch carried.

QoS section (``serve_qos``): a guaranteed and a best-effort tenant share
one deliberately slowed dispatch on `device` under interleaved overload;
the best-effort tenant must shed (reason "qos") while the guaranteed one
records no shed and no SLO miss.

Swarm section (``serve_swarm``): thousands of short-lived TCP connections
against a sharded `SO_REUSEPORT` server, each pushing one batch frame,
and a UDP firehose of fire-and-forget `SUBMIT_BATCH` datagrams with its
measured received fraction.

Any row with `n_slo_miss > 0` triggers a loud stderr warning.

Run directly to write the artifact (never the reference's
`BENCH_serve.json`):

    PYTHONPATH=src python -m benchmarks_torch.serve_throughput \
        [build/BENCH_serve_torch.json] [--device cpu]
"""
from __future__ import annotations

import asyncio
import json
import struct
import sys
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.tnn import exact_netlists
from repro_torch.compile.ir import lower_classifier
from repro_torch.compile.program import CircuitProgram
from repro_torch.serve.engine import CircuitServingEngine
from benchmarks_torch.common import QUICK, get_trained_tnn

OUT_PATH = "build/BENCH_serve_torch.json"

BATCH_SIZES = (1, 64, 1024)
FLEET_DATASETS = ("cardio", "breast_cancer")
WORKER_TENANTS = ("cardio", "breast_cancer", "redwine", "whitewine")
WORKER_PROCS = 2            # spawned worker processes per device
WORKER_FRAME = 2048         # readings per submit_many frame (IPC amortization)
MEGAKERNEL_TENANTS = ("cardio", "breast_cancer", "redwine", "whitewine")
MEGAKERNEL_FRAME = 1024     # readings per frame for the megakernel rows
MEGAKERNEL_DEADLINE_MS = 2000.0   # the row measures fusion economics, not
                                  # a latency SLO
QOS_DELAY_S = 0.005         # synthetic per-dispatch slowdown (overload)
QOS_BACKLOG = 8             # best_effort_backlog for the overload row
FLEET_DEADLINE_MS = 250.0   # above the full-speed replay's queueing delay
SOCKET_BATCH = 256          # readings per SUBMIT_BATCH frame (v2 path)
SWARM_CONNS = 200 if QUICK else 10_000
SWARM_CONCURRENCY = 128 if QUICK else 1000  # open sockets at once (fd cap)
SWARM_READINGS_PER_CONN = 16
SWARM_DEADLINE_MS = 2000.0  # generous: soak measures churn, not latency
UDP_READINGS = 4096 if QUICK else 65_536


def _stream(x_test: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """n readings drawn (with wraparound) from the test distribution."""
    idx = np.random.default_rng(seed).integers(0, x_test.shape[0], size=n)
    return x_test[idx]


def _measure(prog: CircuitProgram, x_test: np.ndarray, batch: int,
             n_readings: int) -> dict:
    engine = CircuitServingEngine(prog, max_batch=batch)
    engine.warmup()
    engine.classify_stream(_stream(x_test, n_readings))
    s = engine.stats.summary()
    return {
        "batch": batch,
        "readings": s["n_readings"],
        "readings_per_s": s["readings_per_s"],
        "p50_ms": s["p50_ms"],
        "p99_ms": s["p99_ms"],
    }


def _fleet_specs_and_streams(n_readings: int, device):
    from repro_torch.serve import TenantSpec

    specs, streams = [], {}
    for i, dataset in enumerate(FLEET_DATASETS):
        ds, tnn = get_trained_tnn(dataset, device=device)
        cc = lower_classifier(tnn, *exact_netlists(tnn))
        name = f"tnn_{dataset}"
        specs.append(TenantSpec(
            name=name,
            program=CircuitProgram.from_classifier(cc, device=device),
            device=device, max_batch=256, deadline_ms=FLEET_DEADLINE_MS,
            dataset=dataset))
        streams[name] = _stream(ds.x_test, n_readings, seed=i)
    return specs, streams


def _report_rows(bench: str, report: dict, deadline_ms: float,
                 **extra) -> list[dict]:
    rows = []
    for name, t in report["tenants"].items():
        rows.append({"bench": bench, "tenant": name,
                     "device": t["device"],
                     "deadline_ms": deadline_ms,
                     "readings": t["n_readings"],
                     "readings_per_s": t["readings_per_s"],
                     "req_p50_ms": t["req_p50_ms"],
                     "req_p99_ms": t["req_p99_ms"],
                     "n_slo_miss": t["n_slo_miss"],
                     "labels_match_offline": t["labels_match_offline"],
                     **extra})
    f = report["fleet"]
    devices = sorted({t["device"] for t in report["tenants"].values()})
    rows.append({"bench": bench, "tenant": "__fleet__",
                 "device": ",".join(devices), "deadline_ms": deadline_ms,
                 "readings": f["n_readings"],
                 "readings_per_s": f["readings_per_s"],
                 "req_p50_ms": f["req_p50_ms"],
                 "req_p99_ms": f["req_p99_ms"],
                 "n_slo_miss": f["n_slo_miss"],
                 "labels_match_offline": report["labels_match_offline"],
                 **extra})
    return rows


def _warn_slo_misses(rows: list[dict]) -> None:
    """Satellite guard: a committed artifact must not quietly carry SLO
    misses — shout about every row that does."""
    for r in rows:
        if r.get("n_slo_miss", 0):
            print(f"\n{'!' * 72}\n"
                  f"!!! WARNING: {r['bench']} tenant={r['tenant']} recorded "
                  f"{r['n_slo_miss']} SLO misses\n"
                  f"!!! (deadline_ms={r.get('deadline_ms')}) — this "
                  f"artifact carries a latency regression\n"
                  f"{'!' * 72}\n", file=sys.stderr)


def _measure_fleet(n_readings: int, device) -> list[dict]:
    """2-tenant concurrent replay through the micro-batching scheduler."""
    from repro_torch.serve import ClassifierFleet
    from repro_torch.serve.__main__ import replay_fleet

    specs, streams = _fleet_specs_and_streams(n_readings, device)
    fleet = ClassifierFleet(specs)
    try:
        report = replay_fleet(fleet, streams, producers=4, timeout=600)
    finally:
        fleet.shutdown(drain=True)
    return _report_rows("serve_fleet", report, FLEET_DEADLINE_MS)


def _frame_replay(fleet, streams: dict, frame: int,
                  preload: bool = False) -> tuple[dict, float]:
    """Feed each tenant whole `(frame, F)` frames through `submit_many`,
    interleaved round-robin across tenants, wait for every handle, and
    check every label bit-identical against the offline reference.
    Returns (report, wall_seconds).

    `preload=True` expects a fleet built with `autostart=False`: every
    frame is queued before the scheduler starts, so the first tick sees
    the whole manifest due at once — the steady-state shape the
    megakernel rows are about (with the scheduler live during the feed,
    frames dispatch one by one as they arrive and a fused launch rarely
    carries more than the tenant that happened to be due)."""
    frames = []
    for name, x in streams.items():
        for f, s in enumerate(range(0, x.shape[0], frame)):
            frames.append((f, name, x[s:s + frame]))
    frames.sort(key=lambda t: t[0])  # round-robin across tenants

    pending = {name: [] for name in streams}
    t0 = time.perf_counter()
    for _, name, rows_ in frames:
        reqs, shed, _ = fleet.submit_many(name, rows_)
        assert shed.size == 0  # no admission limits armed here
        pending[name].extend(reqs)
    if preload:
        fleet.start()
    for reqs in pending.values():
        for r in reqs:
            r.result(timeout=600)
    wall = time.perf_counter() - t0

    report = {"tenants": {}}
    ok_all = True
    for name, reqs in pending.items():
        labels = np.array([r.label for r in reqs], dtype=np.int32)
        t = fleet._tenant(name)
        ref = t.engine.program.predict(streams[name]).astype(np.int32)
        match = bool(np.array_equal(labels, ref))
        ok_all = ok_all and match
        report["tenants"][name] = {
            "device": fleet.tenant_device(name),
            "labels_match_offline": match,
            **t.stats.summary()}
    report["fleet"] = fleet.stats.summary()
    report["labels_match_offline"] = ok_all
    return report, wall


def _measure_workers(n_readings: int, device) -> list[dict]:
    """4-tenant frame replay with dispatch in spawned worker processes.

    The shared-memory hop must not change a single bit — every label is
    checked against the in-process offline reference."""
    from repro_torch.serve import ClassifierFleet, TenantSpec

    specs, streams = [], {}
    for i, dataset in enumerate(WORKER_TENANTS):
        ds, tnn = get_trained_tnn(dataset, device=device)
        cc = lower_classifier(tnn, *exact_netlists(tnn))
        name = f"tnn_{dataset}"
        specs.append(TenantSpec(
            name=name,
            program=CircuitProgram.from_classifier(cc, device=device),
            device=device, max_batch=WORKER_FRAME,
            deadline_ms=FLEET_DEADLINE_MS, dataset=dataset))
        streams[name] = _stream(ds.x_test, n_readings, seed=i)

    fleet = ClassifierFleet(specs, workers=WORKER_PROCS)
    try:
        report, wall = _frame_replay(fleet, streams, WORKER_FRAME)
        total = sum(x.shape[0] for x in streams.values())
    finally:
        fleet.shutdown(drain=True)
    return _report_rows("serve_workers", report, FLEET_DEADLINE_MS,
                        workers=WORKER_PROCS,
                        wall_readings_per_s=round(total / wall, 1))


def _measure_megakernel(n_readings: int, device) -> list[dict]:
    """serve_megakernel rows: the same 4-tenant fleet replayed twice
    — per-tenant dispatch (one kernel launch per tenant batch) vs the
    fused multi-program megakernel (every due tenant in ONE launch per
    scheduler pass).  Both runs check every label bit-identical against
    the offline reference; the megakernel rows also record how many fused
    launches the tick scheduler actually made and the most tenants any
    single launch carried."""
    from repro_torch.serve import ClassifierFleet, TenantSpec

    rows = []
    for mode in ("per_tenant", "megakernel"):
        specs, streams = [], {}
        for i, dataset in enumerate(MEGAKERNEL_TENANTS):
            ds, tnn = get_trained_tnn(dataset, device=device)
            cc = lower_classifier(tnn, *exact_netlists(tnn))
            name = f"tnn_{dataset}"
            specs.append(TenantSpec(
                name=name,
                program=CircuitProgram.from_classifier(cc, device=device),
                device=device, max_batch=MEGAKERNEL_FRAME,
                deadline_ms=MEGAKERNEL_DEADLINE_MS, dataset=dataset))
            streams[name] = _stream(ds.x_test, n_readings, seed=i)
        fleet = ClassifierFleet(specs, megakernel=(mode == "megakernel"),
                                autostart=False)
        try:
            report, wall = _frame_replay(fleet, streams, MEGAKERNEL_FRAME,
                                         preload=True)
            total = sum(x.shape[0] for x in streams.values())
            extra = {"mode": mode,
                     "wall_readings_per_s": round(total / wall, 1)}
            if mode == "megakernel":
                mk = fleet.stats_summary()["megakernel"]
                extra["megakernel_launches"] = mk["launches"]
                extra["peak_tenants_per_launch"] = \
                    mk["peak_tenants_per_launch"]
        finally:
            fleet.shutdown(drain=True)
        rows.extend(_report_rows("serve_megakernel", report,
                                 MEGAKERNEL_DEADLINE_MS, **extra))
    return rows


class _SlowProgram:
    """Delegating wrapper that makes every predict cost `delay_s` — a
    deterministic stand-in for an overloaded dispatch."""

    def __init__(self, inner, delay_s: float):
        self._inner, self._delay_s = inner, delay_s

    def predict(self, x: np.ndarray) -> np.ndarray:
        time.sleep(self._delay_s)
        return self._inner.predict(x)

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def _measure_qos(device) -> list[dict]:
    """serve_qos rows: guaranteed + best-effort tenants sharing one slowed
    backend under interleaved overload.  The committed artifact must show
    the best-effort tenant shedding while the guaranteed tenant keeps
    zero sheds and zero SLO misses."""
    from repro_torch.serve import ClassifierFleet, TenantSpec
    from repro_torch.serve.fleet import FleetOverloadError

    ds, tnn = get_trained_tnn("cardio", device=device)
    cc = lower_classifier(tnn, *exact_netlists(tnn))
    deadline_ms = 20_000.0  # generous: the row measures shedding, not SLO
    specs = [
        TenantSpec(name="gold",
                   program=CircuitProgram.from_classifier(cc, device=device),
                   device=device, max_batch=8, deadline_ms=deadline_ms,
                   qos="guaranteed", dataset="cardio"),
        TenantSpec(name="cheap",
                   program=CircuitProgram.from_classifier(cc, device=device),
                   device=device, max_batch=8, deadline_ms=deadline_ms,
                   max_queue=64, qos="best_effort", dataset="cardio"),
    ]
    fleet = ClassifierFleet(specs, warmup=False, autostart=False,
                            best_effort_backlog=QOS_BACKLOG)
    for name in ("gold", "cheap"):
        for rep in fleet._tenant(name).pool.replicas:
            rep.engine.program = _SlowProgram(rep.engine.program,
                                              QOS_DELAY_S)
    fleet.start()

    n = 256 if QUICK else 1024
    x = _stream(ds.x_test, n, seed=5)
    want = CircuitProgram.from_classifier(
        cc, device=device).predict(x).astype(np.int32)
    gold_reqs, cheap_admitted, cheap_shed = [], 0, 0
    try:
        for i in range(n):
            gold_reqs.append(fleet.submit("gold", x[i]))
            try:
                fleet.submit("cheap", x[i])
                cheap_admitted += 1
            except FleetOverloadError:
                cheap_shed += 1
        labels = np.array([r.result(timeout=600) for r in gold_reqs],
                          dtype=np.int32)
        summary = fleet.stats_summary()["tenants"]
    finally:
        fleet.shutdown(drain=True)

    rows = []
    for tenant, extra in (
            ("gold", {"labels_match_offline":
                      bool(np.array_equal(labels, want))}),
            ("cheap", {"admitted": cheap_admitted,
                       "shed_at_submit": cheap_shed,
                       "best_effort_backlog": QOS_BACKLOG})):
        t = summary[tenant]
        rows.append({"bench": "serve_qos", "tenant": tenant,
                     "qos": t["qos"], "device": t["device"],
                     "deadline_ms": deadline_ms,
                     "readings": t["n_readings"],
                     "n_shed": t["n_shed"],
                     "n_slo_miss": t["n_slo_miss"],
                     "slow_dispatch_s": QOS_DELAY_S, **extra})
    if not (rows[0]["n_shed"] == 0 and rows[0]["n_slo_miss"] == 0
            and rows[1]["n_shed"] > 0):
        print("\n!!! WARNING: serve_qos overload row did not isolate the "
              "guaranteed tenant "
              f"(gold shed={rows[0]['n_shed']} slo={rows[0]['n_slo_miss']},"
              f" cheap shed={rows[1]['n_shed']})", file=sys.stderr)
    return rows


def _measure_socket(bench: str, n_readings: int, batch: int,
                    device) -> list[dict]:
    """The same 2-tenant replay, every reading over the TCP transport —
    `batch` readings per SUBMIT_BATCH frame (1 = classic unary frames)."""
    from repro_torch.serve import ClassifierFleet
    from repro_torch.serve.__main__ import replay_client
    from repro_torch.serve.client import FleetClient
    from repro_torch.serve.server import FleetServer

    specs, streams = _fleet_specs_and_streams(n_readings, device)
    fleet = ClassifierFleet(specs)
    server = FleetServer(fleet)
    try:
        host, port = server.start_background()
        with FleetClient(host, port) as client:
            report = replay_client(client, fleet, streams, producers=4,
                                   timeout=600, batch=batch)
    finally:
        server.stop()
        fleet.shutdown(drain=True)
    return _report_rows(bench, report, FLEET_DEADLINE_MS, batch=batch)


async def _swarm_read_frame(reader: asyncio.StreamReader) -> bytes:
    (ln,) = struct.unpack("!I", await reader.readexactly(4))
    return await reader.readexactly(ln)


async def _swarm_soak(host: str, port: int, tenant: str, x: np.ndarray,
                      ref: np.ndarray, n_conns: int,
                      per_conn: int) -> dict:
    """`n_conns` short-lived connections, each handshaking and pushing one
    `per_conn`-reading batch frame, at most SWARM_CONCURRENCY sockets open
    at once (one process holds both ends on loopback — stay under the fd
    cap).  Labels are checked against the offline reference per
    connection, so the soak doubles as a correctness sweep."""
    from repro_torch.serve import protocol as P

    sem = asyncio.Semaphore(SWARM_CONCURRENCY)
    n_bad = 0

    async def one_conn(c: int) -> int:
        nonlocal n_bad
        s = (c * per_conn) % max(1, x.shape[0] - per_conn)
        rows, want = x[s:s + per_conn], ref[s:s + per_conn]
        async with sem:
            reader, writer = await asyncio.open_connection(host, port)
            try:
                writer.write(P.encode_hello(P.PROTOCOL_VERSION))
                msg = P.decode_message(await _swarm_read_frame(reader))
                assert msg.type == P.MSG_WELCOME and msg.version >= 2
                rids = np.arange(1, per_conn + 1, dtype=np.uint64)
                writer.write(P.encode_submit_batch(rids, tenant, rows))
                await writer.drain()
                got = {}
                while len(got) < per_conn:
                    msg = P.decode_message(await _swarm_read_frame(reader))
                    if msg.type == P.MSG_RESULT_BATCH:
                        for rid, lab in zip(msg.req_ids, msg.labels):
                            got[int(rid)] = int(lab)
                    elif msg.type == P.MSG_RESULT:
                        got[msg.req_id] = msg.label
                    else:
                        raise RuntimeError(f"soak conn {c}: unexpected "
                                           f"message type {msg.type}")
                labels = np.array([got[int(r)] for r in rids])
                if not np.array_equal(labels, want):
                    n_bad += 1
                return per_conn
            finally:
                writer.close()
                await writer.wait_closed()

    t0 = time.perf_counter()
    done = await asyncio.gather(*(one_conn(c) for c in range(n_conns)))
    dt = time.perf_counter() - t0
    return {"n_connections": n_conns, "readings": int(sum(done)),
            "readings_per_s": round(sum(done) / dt, 1),
            "conns_per_s": round(n_conns / dt, 1),
            "labels_match_offline": n_bad == 0}


def _measure_swarm(device) -> list[dict]:
    """serve_swarm rows: the 10k-connection TCP soak against a sharded
    server, then the UDP firehose with its measured received fraction."""
    from repro_torch.serve import ClassifierFleet
    from repro_torch.serve.client import FleetClient, UdpSwarmSender
    from repro_torch.serve.server import FleetServer

    specs, streams = _fleet_specs_and_streams(
        SWARM_READINGS_PER_CONN * 64, device)
    for s in specs:
        s.deadline_ms = SWARM_DEADLINE_MS
    tenant = specs[0].name
    x = streams[tenant]
    ref = specs[0].program.predict(x).astype(np.int32)

    fleet = ClassifierFleet(specs)
    server = FleetServer(fleet, shards=2, udp_port=0)
    rows = []
    try:
        host, port = server.start_background()
        soak = asyncio.run(_swarm_soak(host, port, tenant, x, ref,
                                       SWARM_CONNS,
                                       SWARM_READINGS_PER_CONN))
        with FleetClient(host, port) as admin:
            slo = admin.stats()["fleet"].get("n_slo_miss", 0)
        rows.append({"bench": "serve_swarm", "tenant": tenant,
                     "transport": "tcp_soak", "device": str(device),
                     "deadline_ms": SWARM_DEADLINE_MS,
                     "n_slo_miss": int(slo), "shards": 2, **soak})

        with FleetClient(host, port) as admin:
            before = admin.stats()["transport"]["udp"]
            sender = UdpSwarmSender(host, server.udp_address[1])
            t0 = time.perf_counter()
            sent = 0
            for s in range(0, UDP_READINGS, SOCKET_BATCH):
                idx = np.arange(s, min(s + SOCKET_BATCH,
                                       UDP_READINGS)) % x.shape[0]
                sent += sender.send_many(tenant, x[idx])
            send_s = time.perf_counter() - t0
            sender.close()
            deadline, last = time.monotonic() + 60, -1
            while time.monotonic() < deadline:
                udp = admin.stats()["transport"]["udp"]
                got = udp["n_readings"] - before["n_readings"]
                if got >= sent or (got == last and got > 0):
                    break
                last = got
                time.sleep(0.25)
            udp = admin.stats()["transport"]["udp"]
        received = udp["n_readings"] - before["n_readings"]
        rows.append({"bench": "serve_swarm", "tenant": tenant,
                     "transport": "udp_firehose",
                     "device": str(device),
                     "deadline_ms": SWARM_DEADLINE_MS,
                     "readings_sent": int(sent),
                     "readings_received": int(received),
                     "received_frac": round(received / max(1, sent), 4),
                     "send_rate_per_s": round(sent / max(send_s, 1e-9), 1),
                     "n_errors": udp["n_errors"] - before["n_errors"]})
    finally:
        server.stop()
        fleet.shutdown(drain=True)
    return rows


def run(device=None) -> list[dict]:
    dev = resolve_device(device)
    ds, tnn = get_trained_tnn("cardio", device=dev)
    cc = lower_classifier(tnn, *exact_netlists(tnn))
    prog = CircuitProgram.from_classifier(cc, device=dev)

    rows = []
    for batch in BATCH_SIZES:
        n = (max(256, 4 * batch) if QUICK else max(4096, 64 * batch))
        row = {"bench": "serve", "device": str(dev),
               "gates": cc.ir.n_gates, "depth": cc.ir.depth,
               **_measure(prog, ds.x_test, batch, n)}
        rows.append(row)

    prog_cpu = CircuitProgram.from_classifier(cc, device="cpu")
    n = 2048 if QUICK else 16384
    rows.append({"bench": "serve", "device": "cpu",
                 "gates": cc.ir.n_gates, "depth": cc.ir.depth,
                 **_measure(prog_cpu, ds.x_test, 1024, n)})

    n_fleet = 2048 if QUICK else 16384
    rows.extend(_measure_fleet(n_fleet, dev))
    rows.extend(_measure_workers(n_fleet, dev))
    rows.extend(_measure_megakernel(n_fleet, dev))
    rows.extend(_measure_qos(dev))
    rows.extend(_measure_socket("serve_socket", n_fleet, SOCKET_BATCH, dev))
    rows.extend(_measure_socket("serve_socket_unary",
                                512 if QUICK else 4096, 1, dev))
    rows.extend(_measure_swarm(dev))
    _warn_slo_misses(rows)
    return rows


def main(out_path: str = OUT_PATH, device=None) -> None:
    from pathlib import Path

    dev = resolve_device(device)
    rows = run(device=dev)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"dataset": "cardio", "quick": QUICK, "device": str(dev),
                   "rows": rows}, f, indent=2)
        f.write("\n")
    for r in rows:
        print(r)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    from benchmarks_torch.cgp_throughput import _cli
    main(*_cli(sys.argv[1:]))
