"""The port's wire transport held against `repro.serve` on the CPU.

* **protocol** — the port's codec round-trips every message type, v2
  batch frames and version negotiation, rejects garbage, decodes a batch
  frame near the 64 MiB cap, and writes the reference's bytes for every
  message (so either package reads the other's frames); hypothesis splits
  streams at arbitrary byte boundaries (example budget from
  REPRO_CONFORMANCE_EXAMPLES, as tests/test_conformance.py reads it).
* **bit-identity over the wire** — a port server on 127.0.0.1:0 serving
  the golden manifest (`tests/golden_emit`) on the CPU returns
  `tests/golden/<name>.npz` labels over protocol v2 and v1, pipelined and
  in chunked batch frames.
* **wire compatibility both ways** — the reference `FleetClient` against
  the port's server, and the port's `FleetClient` against the reference's
  server: the same golden labels, over v2 and v1.
* **admission, reload, swarm transports** — the reference's cases: sheds
  under synthetic overload with every accepted request in its SLO, shed
  recovery, the RELOAD RPC and the manifest watcher, partial `submit_many`
  admission, sharded accept loops, UDP ingest and client-side coalescing.
* **CLI** — `exit_code`, `replay` exiting 1 on a mismatch without
  `--strict`, and `replay` in-process and through `--connect` on the CPU.

Every test runs under its own time limit (`LIMIT_S`, a SIGALRM timer), so
a socket that never answers fails its test instead of hanging the suite.
"""
import os
import signal
import socket
import struct
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compile import (  # noqa: E402
    CircuitProgram,
    load_manifest,
    load_program,
    lower_classifier,
    write_artifacts,
)
from repro_torch.core import tnn as T  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClassifierFleet,
    FleetOverloadError,
    TenantSpec,
)
from repro_torch.serve import protocol as P  # noqa: E402
from repro_torch.serve.client import (  # noqa: E402
    FleetClient,
    FleetClientError,
    FleetShedError,
)
from repro_torch.serve.server import FleetServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EMIT_DIR = ROOT / "tests" / "golden_emit"
GOLDEN_DIR = ROOT / "tests" / "golden"
N_EXAMPLES = int(os.environ.get("REPRO_CONFORMANCE_EXAMPLES", "20"))
LIMIT_S = 120
CPU = "cpu"
DEADLINE_MS = 200.0     # the golden servers' budget: a partial batch waits
                        # this long for company before it ships


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail, never hang: SIGALRM raises in the test after `LIMIT_S`."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _toy_classifier(F=9, H=5, Cc=4, seed=7):
    rng = np.random.default_rng(seed)
    w1t = rng.integers(-1, 2, size=(F, H)).astype(np.int8)
    w2t = T.balance_zero_counts(rng.normal(size=(H, Cc)), 1 / 3)
    tnn = T.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(F, 0.5),
                       train_acc=0.0, test_acc=0.0, name=f"toy{seed}")
    return lower_classifier(tnn, *T.exact_netlists(tnn))


class _SlowProgram:
    """Delegating program wrapper that makes every dispatch cost `delay_s`
    — synthetic overload without timing-sensitive producers."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict(self, x):
        time.sleep(self._delay_s)
        return self._inner.predict(x)


# ---------------------------------------------------------------------------
# Protocol: framing + codecs as pure logic
# ---------------------------------------------------------------------------
def _frames():
    x = np.random.default_rng(0).random(7)
    return x, [
        (P.encode_hello(), P.MSG_HELLO, {}),
        (P.encode_welcome(), P.MSG_WELCOME, {}),
        (P.encode_submit(42, "tnn_cardio", x, 12.5), P.MSG_SUBMIT,
         {"req_id": 42, "tenant": "tnn_cardio", "deadline_ms": 12.5}),
        (P.encode_submit(7, "t", x), P.MSG_SUBMIT,
         {"req_id": 7, "deadline_ms": None}),
        (P.encode_result(9, 3, 1.25), P.MSG_RESULT,
         {"req_id": 9, "label": 3, "latency_ms": 1.25}),
        (P.encode_shed(11, 40.0), P.MSG_SHED,
         {"req_id": 11, "retry_after_ms": 40.0}),
        (P.encode_error(13, "boom"), P.MSG_ERROR,
         {"req_id": 13, "message": "boom"}),
        (P.encode_list(), P.MSG_LIST, {}),
        (P.encode_tenants([{"name": "a"}]), P.MSG_TENANTS,
         {"doc": [{"name": "a"}]}),
        (P.encode_stats(), P.MSG_STATS, {}),
        (P.encode_stats_reply({"n": 1}), P.MSG_STATS_REPLY,
         {"doc": {"n": 1}}),
        (P.encode_reload(), P.MSG_RELOAD, {}),
        (P.encode_reloaded({"added": []}), P.MSG_RELOADED,
         {"doc": {"added": []}}),
    ]


def test_protocol_round_trips_every_message_type():
    x, frames = _frames()
    reader = P.FrameReader()
    payloads = reader.feed(b"".join(f for f, _, _ in frames))
    assert len(payloads) == len(frames)
    assert reader.buffered == 0
    for payload, (_, mtype, want) in zip(payloads, frames):
        msg = P.decode_message(payload)
        assert msg.type == mtype
        for key, val in want.items():
            assert getattr(msg, key) == val
    sub = P.decode_message(payloads[2])
    np.testing.assert_array_equal(sub.readings, x)


def test_protocol_bytes_equal_reference():
    """Every encoder writes the reference's bytes, and each side decodes
    the other's frames to the same message."""
    from repro.serve import protocol as RP

    rng = np.random.default_rng(3)
    x, plane = rng.random(7), rng.random((5, 7))
    rids = np.arange(20, 25, dtype=np.uint64)
    dls = np.array([np.nan, 3.0, np.nan, 1e4, 7.5])
    cases = [
        ("encode_hello", ()), ("encode_hello", (1,)),
        ("encode_welcome", ()), ("encode_welcome", (1,)),
        ("encode_submit", (42, "tnn_cardio", x, 12.5)),
        ("encode_submit", (7, "t", x)),
        ("encode_result", (9, 3, 1.25)), ("encode_shed", (11, 40.0)),
        ("encode_error", (13, "boom")), ("encode_list", ()),
        ("encode_tenants", ([{"name": "a", "n_features": 7}],)),
        ("encode_stats", ()), ("encode_stats_reply", ({"n": 1},)),
        ("encode_reload", ()), ("encode_reloaded", ({"added": []},)),
        ("encode_submit_batch", (rids, "t", plane, dls)),
        ("encode_submit_batch", (rids, "t", plane)),
        ("encode_result_batch", (rids, np.arange(5, dtype=np.int32),
                                 np.linspace(0.5, 2.0, 5))),
    ]
    for name, args in cases:
        ours, theirs = getattr(P, name)(*args), getattr(RP, name)(*args)
        assert ours == theirs, name
        a, b = P.decode_message(theirs[4:]), RP.decode_message(ours[4:])
        assert a.type == b.type, name
    assert (P.PROTOCOL_VERSION, P.MAX_FRAME, P.PROTOCOL_MAGIC) == \
        (RP.PROTOCOL_VERSION, RP.MAX_FRAME, RP.PROTOCOL_MAGIC)
    assert P.batch_rows_per_frame(4096) == RP.batch_rows_per_frame(4096)


def test_protocol_rejects_garbage():
    with pytest.raises(P.ProtocolError):
        P.decode_message(b"")
    with pytest.raises(P.ProtocolError):
        P.decode_message(bytes([P.MSG_SUBMIT]) + b"\x00")
    with pytest.raises(P.ProtocolError):
        P.decode_message(bytes([99]))
    with pytest.raises(P.ProtocolError):
        P.decode_message(bytes([P.MSG_HELLO]) + b"NOPE\x01")
    with pytest.raises(P.ProtocolError):
        P.decode_message(bytes([P.MSG_HELLO]) + P.PROTOCOL_MAGIC
                         + bytes([P.PROTOCOL_VERSION + 1]))
    reader = P.FrameReader(max_frame=16)
    with pytest.raises(P.ProtocolError):
        reader.feed(b"\xff\xff\xff\xff")


def test_protocol_v2_batch_frames_round_trip():
    rng = np.random.default_rng(1)
    x = rng.random((13, 7))
    rids = np.arange(100, 113, dtype=np.uint64)
    dls = np.full(13, np.nan)
    dls[3] = 12.5
    (payload,) = P.FrameReader().feed(
        P.encode_submit_batch(rids, "tnn_cardio", x, dls))
    msg = P.decode_message(payload)
    assert msg.type == P.MSG_SUBMIT_BATCH and msg.tenant == "tnn_cardio"
    np.testing.assert_array_equal(msg.req_ids, rids)
    np.testing.assert_array_equal(msg.readings, x)
    assert np.isnan(msg.deadlines_ms[0]) and msg.deadlines_ms[3] == 12.5
    labels = (np.arange(13) % 4).astype(np.int32)
    lats = np.linspace(0.5, 2.0, 13)
    (payload,) = P.FrameReader().feed(
        P.encode_result_batch(rids, labels, lats))
    msg = P.decode_message(payload)
    assert msg.type == P.MSG_RESULT_BATCH
    np.testing.assert_array_equal(msg.req_ids, rids)
    np.testing.assert_array_equal(msg.labels, labels)
    np.testing.assert_allclose(msg.latencies_ms, lats)


def test_protocol_version_negotiation():
    assert P.negotiate_version(1) == 1
    assert P.negotiate_version(P.PROTOCOL_VERSION) == P.PROTOCOL_VERSION
    assert P.negotiate_version(99) == P.PROTOCOL_VERSION
    with pytest.raises(P.ProtocolError):
        P.negotiate_version(0)
    assert P.decode_message(P.encode_hello(1)[4:]).version == 1
    assert P.decode_message(P.encode_welcome(2)[4:]).version == 2


def test_batch_frame_near_the_64mib_cap_decodes():
    F = 4096
    rows = P.batch_rows_per_frame(F)
    frame = P.encode_submit_batch(np.arange(rows, dtype=np.uint64), "t",
                                  np.zeros((rows, F)))
    assert len(frame) - 4 <= P.MAX_FRAME
    assert len(frame) - 4 > 0.95 * P.MAX_FRAME
    (payload,) = P.FrameReader().feed(frame)
    assert P.decode_message(payload).readings.shape == (rows, F)
    with pytest.raises(P.ProtocolError):
        P.FrameReader().feed(struct.pack("!I", P.MAX_FRAME + 1))


try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:

    @settings(max_examples=N_EXAMPLES, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 2**64 - 1),
                              st.integers(0, 2**31 - 1),
                              st.floats(0, 1e6, allow_nan=False)),
                    max_size=24),
           st.randoms(use_true_random=False))
    def test_frame_reader_survives_arbitrary_chunking(results, rnd):
        stream = b"".join(P.encode_result(rid, lbl, lat)
                          for rid, lbl, lat in results)
        reader = P.FrameReader()
        out, i = [], 0
        while i < len(stream):
            j = min(len(stream), i + rnd.randint(1, 7))
            out.extend(reader.feed(stream[i:j]))
            i = j
        assert reader.buffered == 0
        got = [P.decode_message(p) for p in out]
        assert [(m.req_id, m.label, m.latency_ms) for m in got] == \
            [(rid, lbl, lat) for rid, lbl, lat in results]

    @settings(max_examples=N_EXAMPLES, deadline=None)
    @given(st.lists(st.tuples(st.integers(1, 9), st.integers(1, 6),
                              st.integers(0, 2**32)),
                    min_size=1, max_size=6),
           st.randoms(use_true_random=False))
    def test_batch_frames_survive_arbitrary_chunking(shapes, rnd):
        frames, want = [], []
        for k, (b, f, seed) in enumerate(shapes):
            x = np.random.default_rng(seed).random((b, f))
            rids = np.arange(k * 1000, k * 1000 + b, dtype=np.uint64)
            frames.append(P.encode_submit_batch(rids, f"t{k}", x))
            want.append((f"t{k}", rids, x))
        stream = b"".join(frames)
        reader = P.FrameReader()
        out, i = [], 0
        while i < len(stream):
            j = min(len(stream), i + rnd.randint(1, 7))
            out.extend(reader.feed(stream[i:j]))
            i = j
        assert reader.buffered == 0 and len(out) == len(frames)
        for payload, (tenant, rids, x) in zip(out, want):
            msg = P.decode_message(payload)
            assert msg.tenant == tenant
            np.testing.assert_array_equal(msg.req_ids, rids)
            np.testing.assert_array_equal(msg.readings, x)


# ---------------------------------------------------------------------------
# Socket serving of the golden manifest, both ways across the packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    out = {}
    for row in load_manifest(EMIT_DIR):
        with np.load(GOLDEN_DIR / f"{row['name']}.npz") as fix:
            out[row["name"]] = (fix["x"], fix["labels"])
    return out


@pytest.fixture(scope="module")
def port_server():
    fleet = ClassifierFleet.from_emit_dir(EMIT_DIR, device=CPU, max_batch=64,
                                          deadline_ms=DEADLINE_MS)
    server = FleetServer(fleet)
    host, port = server.start_background()
    yield host, port
    server.stop()
    fleet.shutdown(drain=True)


@pytest.fixture(scope="module")
def reference_server():
    from repro.serve import ClassifierFleet as RefFleet
    from repro.serve.server import FleetServer as RefServer

    fleet = RefFleet.from_emit_dir(EMIT_DIR, backends="swar", max_batch=64,
                                   deadline_ms=DEADLINE_MS)
    server = RefServer(fleet)
    host, port = server.start_background()
    yield host, port
    server.stop()
    fleet.shutdown(drain=True)


@pytest.mark.parametrize("version", [P.PROTOCOL_VERSION, 1])
def test_port_server_labels_bit_identical(port_server, golden, version):
    host, port = port_server
    with FleetClient(host, port, protocol_version=version) as client:
        assert client.protocol_version == version
        rows = {r["name"]: r for r in client.tenants()}
        assert set(rows) == set(golden)
        for name, (x, labels) in sorted(golden.items()):
            assert rows[name]["backend"] == "cpu"       # the device's name
            assert rows[name]["n_features"] == x.shape[1]
            np.testing.assert_array_equal(
                client.classify(name, x, timeout=60.0), labels,
                err_msg=name)


@pytest.mark.parametrize("version", [2, 1])
def test_reference_client_against_port_server(port_server, golden, version):
    from repro.serve.client import FleetClient as RefClient

    host, port = port_server
    with RefClient(host, port, protocol_version=version) as client:
        assert client.protocol_version == version
        assert {r["name"] for r in client.tenants()} == set(golden)
        for name, (x, labels) in sorted(golden.items()):
            np.testing.assert_array_equal(
                client.classify(name, x, timeout=60.0), labels,
                err_msg=name)
        assert client.stats()["fleet"]["n_requests"] >= sum(
            x.shape[0] for x, _ in golden.values())


@pytest.mark.parametrize("version", [P.PROTOCOL_VERSION, 1])
def test_port_client_against_reference_server(reference_server, golden,
                                              version):
    host, port = reference_server
    with FleetClient(host, port, protocol_version=version) as client:
        assert client.protocol_version == version
        assert {r["name"] for r in client.tenants()} == set(golden)
        for name, (x, labels) in sorted(golden.items()):
            np.testing.assert_array_equal(
                client.classify(name, x, timeout=60.0), labels,
                err_msg=name)


def test_socket_pipelines_interleaved_tenants(port_server, golden):
    host, port = port_server
    with FleetClient(host, port) as client:
        pend = []
        for i in range(max(x.shape[0] for x, _ in golden.values())):
            for t in sorted(golden):
                if i < golden[t][0].shape[0]:
                    pend.append((t, i, client.submit(t, golden[t][0][i])))
        for t, i, p in pend:
            assert p.result(timeout=60.0) == int(golden[t][1][i]), (t, i)


def test_submit_many_chunks_batch_frames_bit_identical(port_server, golden):
    host, port = port_server
    x, labels = golden["whitewine"]
    with FleetClient(host, port) as client:
        handles = client.submit_many("whitewine", x, max_frame=1 << 12)
        got = np.array([h.result(60.0) for h in handles], dtype=np.int32)
    np.testing.assert_array_equal(got, labels)


def test_server_reports_stats_and_errors(port_server, golden):
    host, port = port_server
    with FleetClient(host, port) as client:
        tenant = sorted(golden)[0]
        client.classify(tenant, golden[tenant][0][:8], timeout=60.0)
        s = client.stats()
        assert s["fleet"]["n_requests"] >= 8
        assert s["tenants"][tenant]["device"] == "cpu"
        assert s["transport"]["shards"] == 1
        with pytest.raises(FleetClientError, match="unknown tenant"):
            client.submit("no_such_tenant", golden[tenant][0][0]).result(30.0)
        with pytest.raises(FleetClientError, match="features"):
            client.submit(tenant, np.zeros(1)).result(30.0)


def test_oversized_batch_gets_clean_error_not_a_hung_connection(port_server):
    host, port = port_server

    def read_frame(s):
        head = b""
        while len(head) < 4:
            head += s.recv(4 - len(head))
        (ln,) = struct.unpack("!I", head)
        buf = b""
        while len(buf) < ln:
            buf += s.recv(ln - len(buf))
        return buf

    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall(P.encode_hello())
        assert P.decode_message(read_frame(s)).type == P.MSG_WELCOME
        s.sendall(struct.pack("!I", P.MAX_FRAME + 1))
        msg = P.decode_message(read_frame(s))
        assert msg.type == P.MSG_ERROR and msg.req_id == P.CONN_ERR
        assert s.recv(1) == b""


# ---------------------------------------------------------------------------
# Admission control, hot reload, batched ingest (the reference's cases)
# ---------------------------------------------------------------------------
def test_overload_sheds_nonzero_and_accepted_requests_meet_slo():
    cc = _toy_classifier()
    prog = CircuitProgram.from_classifier(cc, device=CPU)
    deadline_ms = 20_000.0
    spec = TenantSpec(name="slow", program=prog, device=CPU, max_batch=8,
                      deadline_ms=deadline_ms, max_queue=16)
    fleet = ClassifierFleet([spec], warmup=False, autostart=False)
    for rep in fleet._tenant("slow").pool.replicas:
        rep.engine.program = _SlowProgram(rep.engine.program, 0.02)
    fleet.start()
    server = FleetServer(fleet)
    host, port = server.start_background()
    x = np.random.default_rng(3).random((400, 9))
    want = prog.predict(x)
    accepted, sheds = [], 0
    try:
        with FleetClient(host, port) as client:
            pend = [client.submit("slow", row, deadline_ms=deadline_ms)
                    for row in x]
            for i, p in enumerate(pend):
                try:
                    label = p.result(timeout=60.0)
                except FleetShedError as exc:
                    sheds += 1
                    assert exc.retry_after_ms >= 1.0
                else:
                    accepted.append((i, label))
            stats = client.stats()
    finally:
        server.stop()
        fleet.shutdown(drain=True)
    assert sheds > 0
    assert len(accepted) + sheds == x.shape[0]
    assert len(accepted) > 0
    for i, label in accepted:
        assert label == int(want[i]), i
    tstats = stats["tenants"]["slow"]
    assert stats["fleet"]["n_shed"] == tstats["n_shed"] == sheds
    assert tstats["n_slo_miss"] == 0
    assert stats["fleet"]["n_slo_miss"] == 0


def test_shed_recovers_once_backlog_drains():
    prog = CircuitProgram.from_classifier(_toy_classifier(seed=11),
                                          device=CPU)
    spec = TenantSpec(name="t", program=prog, device=CPU, max_batch=4,
                      deadline_ms=60_000.0, max_queue=8)
    fleet = ClassifierFleet([spec], warmup=False, autostart=False)
    for rep in fleet._tenant("t").pool.replicas:
        rep.engine.program = _SlowProgram(rep.engine.program, 0.01)
    fleet.start()
    x = np.random.default_rng(5).random((64, 9))
    try:
        shed = 0
        for row in x:
            try:
                fleet.submit("t", row)
            except FleetOverloadError:
                shed += 1
        assert shed > 0
        fleet.flush(timeout=60.0)
        req = fleet.submit("t", x[0], deadline_ms=200.0)
        assert req.result(timeout=30.0) is not None
    finally:
        fleet.shutdown(drain=True)


def test_server_hot_reload_rpc_and_watcher(tmp_path):
    write_artifacts(_toy_classifier(seed=7), tmp_path, base="alpha")
    fleet = ClassifierFleet.from_emit_dir(tmp_path, device=CPU,
                                          max_batch=32, deadline_ms=500.0)
    server = FleetServer(fleet, watch_manifest=True, watch_interval_s=0.05)
    host, port = server.start_background()
    try:
        with FleetClient(host, port) as client:
            assert [t["name"] for t in client.tenants()] == ["alpha"]
            cc_beta = _toy_classifier(F=6, H=4, Cc=3, seed=11)
            write_artifacts(cc_beta, tmp_path, base="beta")
            actions = client.reload()
            assert actions["added"] in ([], ["beta"])
            assert "beta" in {t["name"] for t in client.tenants()}
            x = np.random.default_rng(0).random((16, 6))
            np.testing.assert_array_equal(
                client.classify("beta", x, timeout=60.0),
                CircuitProgram.from_classifier(cc_beta, device=CPU)
                .predict(x))
            gen = [t for t in client.tenants()
                   if t["name"] == "alpha"][0]["generation"]
            write_artifacts(_toy_classifier(seed=42), tmp_path, base="alpha")
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                rows = {t["name"]: t for t in client.tenants()}
                if rows["alpha"]["generation"] > gen:
                    break
                time.sleep(0.05)
            else:
                pytest.fail("watcher never hot-reloaded the re-emitted "
                            "tenant")
            labels = client.classify("alpha",
                                     np.random.default_rng(1).random((8, 9)),
                                     timeout=60.0)
            assert labels.shape == (8,)
    finally:
        server.stop()
        fleet.shutdown(drain=True)


def test_fleet_submit_many_partial_admission_and_identity():
    prog = CircuitProgram.from_classifier(_toy_classifier(), device=CPU)
    spec = TenantSpec(name="t", program=prog, device=CPU, max_batch=8,
                      deadline_ms=20_000.0, max_queue=16)
    fleet = ClassifierFleet([spec], warmup=False, autostart=False)
    for rep in fleet._tenant("t").pool.replicas:
        rep.engine.program = _SlowProgram(rep.engine.program, 0.01)
    fleet.start()
    x = np.random.default_rng(5).random((64, 9))
    want = prog.predict(x)
    try:
        reqs, shed_idx, retry_ms = fleet.submit_many("t", x)
        assert len(reqs) + len(shed_idx) == 64
        assert len(shed_idx) >= 64 - 16 > 0 and retry_ms > 0
        np.testing.assert_array_equal(
            shed_idx, np.arange(64 - len(shed_idx), 64))
        for r in reqs:
            r.result(60.0)
        labels = np.array([r.label for r in reqs], dtype=np.int32)
        np.testing.assert_array_equal(labels, want[:len(reqs)])
    finally:
        fleet.shutdown(drain=True)


def test_sharded_server_udp_ingest_and_coalescer():
    from repro_torch.serve.client import (CoalescingSubmitter,
                                          UdpSwarmSender)

    prog = CircuitProgram.from_classifier(_toy_classifier(), device=CPU)
    spec = TenantSpec(name="t", program=prog, device=CPU, max_batch=32,
                      deadline_ms=10_000.0)
    fleet = ClassifierFleet([spec], warmup=False)
    server = FleetServer(fleet, shards=2, udp_port=0)
    host, port = server.start_background()
    x = np.random.default_rng(11).random((96, 9))
    want = prog.predict(x).astype(np.int32)
    try:
        with FleetClient(host, port) as c, FleetClient(host, port) as c2:
            np.testing.assert_array_equal(
                c2.classify("t", x[:32], timeout=60.0), want[:32])
            with CoalescingSubmitter(c, max_rows=16,
                                     max_delay_ms=25.0) as cs:
                pends = [cs.submit("t", x[i]) for i in range(40)]
                got = np.array([p.result(60.0) for p in pends],
                               dtype=np.int32)
            np.testing.assert_array_equal(got, want[:40])
            before = c.stats()["transport"]["udp"]["n_readings"]
            with UdpSwarmSender(host, server.udp_address[1]) as u:
                n = u.send_many("t", x)
                u.send("t", x[0])
            deadline = time.monotonic() + 30
            got_n = 0
            while time.monotonic() < deadline:
                got_n = c.stats()["transport"]["udp"]["n_readings"] - before
                if got_n >= n + 1:
                    break
                time.sleep(0.05)
            assert got_n == n + 1, f"UDP ingest saw {got_n}/{n + 1}"
            assert c.stats()["transport"]["shards"] == 2
    finally:
        server.stop()
        fleet.shutdown(drain=True)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _fake_report(match: bool, slo_miss: int = 0, shed: int = 0,
                 errors: list | None = None) -> dict:
    return {
        "tenants": {"t": {"device": "cpu", "replicas": 1, "dataset": "d",
                          "readings": 4, "labels_match_offline": match,
                          "slo_miss": slo_miss, "n_shed": shed,
                          "worst_latency_ms": 1.0, "req_p50_ms": 1.0,
                          "req_p99_ms": 1.0}},
        "fleet": {"n_readings": 4, "n_batches": 1, "n_slo_miss": slo_miss,
                  "n_shed": shed, "req_p99_ms": 1.0},
        "errors": errors or [],
        "labels_match_offline": match,
        "transport": "inproc",
        "producers": 1,
    }


def test_exit_code_mismatch_fails_without_strict():
    from repro_torch.serve.__main__ import exit_code

    assert exit_code(_fake_report(True), strict=False) == 0
    assert exit_code(_fake_report(False), strict=False) == 1
    assert exit_code(_fake_report(False), strict=True) == 1
    assert exit_code(_fake_report(True, errors=["boom"]), strict=False) == 1
    assert exit_code(_fake_report(True, slo_miss=3), strict=False) == 0
    assert exit_code(_fake_report(True, slo_miss=3), strict=True) == 1
    assert exit_code(_fake_report(True, shed=2), strict=False) == 0
    assert exit_code(_fake_report(True, shed=2), strict=True) == 1


def test_replay_cli_exits_nonzero_on_mismatch_without_strict(monkeypatch):
    import repro_torch.serve.__main__ as M

    monkeypatch.setattr(
        M, "replay_fleet",
        lambda fleet, streams, producers=4, timeout=120.0:
            _fake_report(False))
    rc = M.main(["replay", "--emit-dir", str(EMIT_DIR), "--device", "cpu",
                 "--replay", "cardio", "--readings", "4", "--producers", "1"])
    assert rc == 1
    rc = M.main(["--emit-dir", str(EMIT_DIR), "--device", "cpu",
                 "--replay", "cardio", "--readings", "4", "--producers", "1"])
    assert rc == 1


def test_replay_cli_in_process_and_over_the_socket(port_server, tmp_path):
    import json

    import repro_torch.serve.__main__ as M

    out = tmp_path / "inproc.json"
    rc = M.main(["replay", "--emit-dir", str(EMIT_DIR), "--device", "cpu",
                 "--replay", "cardio,redwine", "--readings", "64",
                 "--producers", "2", "--deadline-ms", "200",
                 "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["labels_match_offline"]
    assert report["tenants"]["cardio"]["device"] == "cpu"
    host, port = port_server
    out = tmp_path / "socket.json"
    rc = M.main(["replay", "--emit-dir", str(EMIT_DIR), "--device", "cpu",
                 "--connect", f"{host}:{port}", "--replay", "all",
                 "--readings", "64", "--batch", "32", "--producers", "2",
                 "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["labels_match_offline"]
    assert report["protocol_version"] == P.PROTOCOL_VERSION
    assert {r["device"] for r in report["tenants"].values()} == {"cpu"}
