"""Blocking client for the fleet's socket transport.

The port's copy of `repro.serve.client`, as it is: it speaks to a server
of either package.

The consumer half of `protocol.py`: one TCP connection, a background
reader thread that de-frames RESULT/RESULT_BATCH/SHED/ERROR messages and
resolves them against pending request handles by req_id, and a pipelined
submit path — `submit` returns a `PendingResult` immediately, so a
producer can keep thousands of readings in flight and collect labels in
completion order.  This is what the replay CLI (`python -m repro_torch.serve
replay --connect host:port`) and the cross-process CI smoke drive; it
has no dependency on the fleet, so a sensor gateway can vendor just
`protocol.py` + this file.

The protocol version is negotiated at HELLO (the server answers WELCOME
with ``min(client, server)``); on a v2 connection `submit_many` ships a
whole ``(B, F)`` reading plane as one `SUBMIT_BATCH` frame per
`batch_rows_per_frame` chunk — one syscall for thousands of readings —
and transparently falls back to coalesced per-reading SUBMIT frames when
the server only speaks v1.  `CoalescingSubmitter` adds optional
time/size-based client-side coalescing on top (single-reading producers
get batch frames without changing their call sites), and
`UdpSwarmSender` is the connectionless fire-and-forget path: SUBMIT /
SUBMIT_BATCH payloads as raw datagrams, no handshake, no replies, no
delivery guarantee.

Admission sheds surface as `FleetShedError` (carrying the server's
`retry_after_ms` hint) from `PendingResult.result()`; `classify` can
optionally honor the hint and resubmit (`retry_shed=True`), which is the
polite-producer loop the admission controller is designed for.
"""
from __future__ import annotations

import socket
import threading
import time
from queue import Empty, Queue

import numpy as np

from repro_torch.serve import protocol as P


class FleetClientError(RuntimeError):
    """Connection-level failure (bad handshake, server error, disconnect)."""


class FleetShedError(RuntimeError):
    """The server shed this submission; retry after `retry_after_ms`."""

    def __init__(self, req_id: int, retry_after_ms: float):
        super().__init__(f"request {req_id} shed by admission control; "
                         f"retry after {retry_after_ms:.1f} ms")
        self.req_id = req_id
        self.retry_after_ms = retry_after_ms


class PendingResult:
    """Completion handle for one submitted reading."""

    def __init__(self, req_id: int, tenant: str):
        self.req_id = req_id
        self.tenant = tenant
        self.label: int | None = None
        self.latency_ms: float | None = None    # server-side submit -> label
        self.error: str | None = None
        self.retry_after_ms: float | None = None    # set iff shed
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def shed(self) -> bool:
        return self.retry_after_ms is not None

    def result(self, timeout: float | None = None) -> int:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.req_id} ({self.tenant}) not "
                               f"answered within {timeout}s")
        if self.retry_after_ms is not None:
            raise FleetShedError(self.req_id, self.retry_after_ms)
        if self.error is not None:
            raise FleetClientError(f"request {self.req_id} ({self.tenant}) "
                                   f"failed: {self.error}")
        return self.label


class FleetClient:
    """One connection to a `FleetServer`; safe for multi-threaded submits."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 10.0,
                 protocol_version: int = P.PROTOCOL_VERSION):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._pending: dict[int, PendingResult] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 1
        self._closed = False
        self._conn_error: str | None = None
        self._welcome = threading.Event()
        self.protocol_version = protocol_version    # negotiated at WELCOME
        self._rpc: dict[int, Queue] = {P.MSG_TENANTS: Queue(),
                                       P.MSG_STATS_REPLY: Queue(),
                                       P.MSG_RELOADED: Queue()}
        self._rpc_lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="fleet-client-reader",
                                        daemon=True)
        self._reader.start()
        self._sendall(P.encode_hello(protocol_version))
        if not self._welcome.wait(connect_timeout):
            err = self._conn_error or "no WELCOME from server"
            self.close()
            raise FleetClientError(f"handshake failed: {err}")

    # -- wire plumbing -------------------------------------------------------
    def _sendall(self, data: bytes) -> None:
        with self._send_lock:
            if self._closed:
                raise FleetClientError("client is closed")
            try:
                self._sock.sendall(data)
            except OSError as exc:
                raise FleetClientError(f"send failed: {exc}") from exc

    def _read_loop(self) -> None:
        framer = P.FrameReader()
        try:
            while True:
                chunk = self._sock.recv(1 << 16)
                if not chunk:
                    break
                for payload in framer.feed(chunk):
                    self._on_message(P.decode_message(payload))
        except (OSError, P.ProtocolError) as exc:
            if not self._closed:
                self._conn_error = self._conn_error or str(exc)
        finally:
            self._fail_all(self._conn_error or "connection closed")
            self._welcome.set()     # unblock a handshake waiter, if any

    def _resolve(self, req_id: int, label: int | None,
                 latency_ms: float | None, error: str | None = None,
                 retry_after_ms: float | None = None) -> None:
        with self._pending_lock:
            pend = self._pending.pop(req_id, None)
        if pend is None:
            return                  # late answer for an abandoned request
        pend.label = label
        pend.latency_ms = latency_ms
        pend.error = error
        pend.retry_after_ms = retry_after_ms
        pend._event.set()

    def _on_message(self, msg: P.Message) -> None:
        if msg.type == P.MSG_WELCOME:
            self.protocol_version = min(self.protocol_version, msg.version)
            self._welcome.set()
        elif msg.type == P.MSG_RESULT_BATCH:
            for rid, label, lat in zip(msg.req_ids, msg.labels,
                                       msg.latencies_ms):
                self._resolve(int(rid), int(label), float(lat))
        elif msg.type in (P.MSG_RESULT, P.MSG_SHED, P.MSG_ERROR):
            if msg.type == P.MSG_ERROR and msg.req_id == P.CONN_ERR:
                self._conn_error = msg.message
                self._fail_all(f"server: {msg.message}")
                return
            with self._pending_lock:
                pend = self._pending.pop(msg.req_id, None)
            if pend is None:
                return              # late answer for an abandoned request
            if msg.type == P.MSG_RESULT:
                pend.label = msg.label
                pend.latency_ms = msg.latency_ms
            elif msg.type == P.MSG_SHED:
                pend.retry_after_ms = msg.retry_after_ms
            else:
                pend.error = msg.message
            pend._event.set()
        elif msg.type in self._rpc:
            self._rpc[msg.type].put(msg.doc)

    def _fail_all(self, why: str) -> None:
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for pend in pending.values():
            pend.error = why
            pend._event.set()

    # -- request path --------------------------------------------------------
    def submit(self, tenant: str, readings: np.ndarray,
               deadline_ms: float | None = None) -> PendingResult:
        """Pipeline one reading; returns immediately with a handle."""
        if self._conn_error is not None:
            raise FleetClientError(self._conn_error)
        with self._pending_lock:
            req_id = self._next_id
            self._next_id += 1
            pend = PendingResult(req_id, tenant)
            self._pending[req_id] = pend
        try:
            self._sendall(P.encode_submit(req_id, tenant, readings,
                                          deadline_ms))
        except FleetClientError:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise
        return pend

    def submit_many(self, tenant: str, x: np.ndarray,
                    deadlines_ms=None, *,
                    max_frame: int = P.MAX_FRAME) -> list[PendingResult]:
        """Pipeline a whole `(B, F)` reading plane; one handle per row.

        On a v2 connection the plane ships as `SUBMIT_BATCH` frames
        (auto-chunked to stay under the frame cap — `max_frame` exists so
        tests can force chunking without 64 MiB of traffic); a v1 server
        gets per-reading SUBMIT frames coalesced into one send.  Either
        way every reading costs a fraction of a syscall instead of a
        full frame + write round trip.  `deadlines_ms` is None, a
        scalar, or one value per row (NaN = the tenant's default budget).
        """
        if self._conn_error is not None:
            raise FleetClientError(self._conn_error)
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
        if x.ndim != 2:
            raise ValueError(f"expected (B, F) readings, got {x.shape}")
        B = x.shape[0]
        if B == 0:
            return []
        dls = (None if deadlines_ms is None else
               np.broadcast_to(np.asarray(deadlines_ms, dtype=np.float64),
                               (B,)))
        with self._pending_lock:
            req_id0 = self._next_id
            self._next_id += B
            handles = [PendingResult(req_id0 + i, tenant) for i in range(B)]
            self._pending.update((h.req_id, h) for h in handles)
        req_ids = np.arange(req_id0, req_id0 + B, dtype=np.uint64)
        try:
            if self.protocol_version >= 2:
                step = P.batch_rows_per_frame(x.shape[1], max_frame)
                for s in range(0, B, step):
                    e = min(B, s + step)
                    self._sendall(P.encode_submit_batch(
                        req_ids[s:e], tenant, x[s:e],
                        None if dls is None else dls[s:e]))
            else:               # v1 server: coalesce classic SUBMIT frames
                self._sendall(b"".join(
                    P.encode_submit(
                        int(req_ids[i]), tenant, x[i],
                        None if dls is None or dls[i] != dls[i]
                        else float(dls[i]))
                    for i in range(B)))
        except FleetClientError:
            with self._pending_lock:
                for h in handles:
                    self._pending.pop(h.req_id, None)
            raise
        return handles

    def classify(self, tenant: str, x: np.ndarray,
                 deadline_ms: float | None = None, *,
                 timeout: float = 120.0, retry_shed: bool = False,
                 max_retries: int = 64) -> np.ndarray:
        """Submit every row of `(S, F)` readings; block for `(S,)` labels.

        Rows travel via `submit_many` (batch frames on a v2 connection).
        With `retry_shed`, a shed row sleeps out the server's
        `retry_after_ms` hint and resubmits (up to `max_retries` times) —
        the cooperative backoff loop admission control expects of bulk
        producers.
        """
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected (S, F) readings, got {x.shape}")
        handles = self.submit_many(tenant, x, deadline_ms)
        labels = np.empty(x.shape[0], dtype=np.int32)
        deadline = time.monotonic() + timeout
        for i, pend in enumerate(handles):
            for attempt in range(max_retries + 1):
                try:
                    labels[i] = pend.result(max(0.0, deadline
                                                - time.monotonic()))
                    break
                except FleetShedError as exc:
                    if not retry_shed or attempt == max_retries:
                        raise
                    time.sleep(min(exc.retry_after_ms, 1000.0) * 1e-3)
                    pend = self.submit(tenant, x[i], deadline_ms)
        return labels

    # -- admin round-trips ---------------------------------------------------
    def _rpc_call(self, request: bytes, reply_type: int,
                  timeout: float):
        with self._rpc_lock:        # one outstanding admin call at a time
            q = self._rpc[reply_type]
            while True:     # a reply that arrived after a past timeout is
                try:        # stale — drop it or every later call is off by one
                    q.get_nowait()
                except Empty:
                    break
            self._sendall(request)
            try:
                return q.get(timeout=timeout)
            except Empty:
                raise TimeoutError(
                    f"no reply (type {reply_type}) within {timeout}s; "
                    + (self._conn_error or "server unresponsive")) from None

    def tenants(self, timeout: float = 30.0) -> list[dict]:
        """The server's tenant table (name, n_features, backend, ...)."""
        return self._rpc_call(P.encode_list(), P.MSG_TENANTS, timeout)

    def stats(self, timeout: float = 30.0) -> dict:
        """The server fleet's `stats_summary()`."""
        return self._rpc_call(P.encode_stats(), P.MSG_STATS_REPLY, timeout)

    def reload(self, timeout: float = 120.0) -> dict:
        """Ask the server to `sync_manifest()`; returns the action record."""
        return self._rpc_call(P.encode_reload(), P.MSG_RELOADED, timeout)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if threading.current_thread() is not self._reader:
            self._reader.join(5.0)

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CoalescingSubmitter:
    """Time/size-based client-side coalescing over one `FleetClient`.

    Single-reading producers keep their per-reading call site —
    ``submit(tenant, row)`` returns a `PendingResult` immediately — but
    rows accumulate in a per-tenant buffer that ships as one
    `submit_many` plane when it reaches `max_rows` **or** when its oldest
    row has waited `max_delay_ms` (a background ticker flushes stale
    buffers, so a trickle of readings is never stranded).  The classic
    latency/amortization trade, client-side: bound the added latency,
    amortize the wire cost.
    """

    def __init__(self, client: FleetClient, *, max_rows: int = 256,
                 max_delay_ms: float = 5.0):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        if max_delay_ms <= 0:
            raise ValueError("max_delay_ms must be positive")
        self.client = client
        self.max_rows = max_rows
        self.max_delay_ms = max_delay_ms
        self._buffers: dict[str, list] = {}     # tenant -> [(row, dl), ...]
        self._oldest: dict[str, float] = {}     # tenant -> first-row instant
        self._lock = threading.Lock()
        self._closed = False
        self._wake = threading.Event()
        self._ticker = threading.Thread(target=self._tick_loop,
                                        name="coalescing-submitter",
                                        daemon=True)
        self._ticker.start()

    def submit(self, tenant: str, readings: np.ndarray,
               deadline_ms: float | None = None) -> "PendingResult":
        row = np.asarray(readings, dtype=np.float64).reshape(-1)
        pend = PendingResult(0, tenant)     # req_id assigned at flush
        flush_rows = None
        with self._lock:
            if self._closed:
                raise FleetClientError("submitter is closed")
            buf = self._buffers.setdefault(tenant, [])
            if not buf:
                self._oldest[tenant] = time.monotonic()
            buf.append((row, deadline_ms, pend))
            if len(buf) >= self.max_rows:
                flush_rows = self._take_locked(tenant)
        if flush_rows:
            self._ship(tenant, flush_rows)
        return pend

    def _take_locked(self, tenant: str) -> list:
        rows = self._buffers.pop(tenant, [])
        self._oldest.pop(tenant, None)
        return rows

    def _ship(self, tenant: str, rows: list) -> None:
        plane = np.stack([r for r, _, _ in rows])
        dls = np.array([np.nan if d is None else float(d)
                        for _, d, _ in rows])
        try:
            handles = self.client.submit_many(tenant, plane, dls)
        except FleetClientError:
            for _, _, pend in rows:     # resolve, or result() waits forever
                pend.error = self.client._conn_error or "send failed"
                pend._event.set()
            raise
        for (_, _, pend), h in zip(rows, handles):
            pend.req_id = h.req_id
            # Swap the caller's handle in for the internal one — unless the
            # result already landed, in which case copy it over.  _resolve
            # pops under _pending_lock, so exactly one branch runs.
            with self.client._pending_lock:
                landed = h.req_id not in self.client._pending
                if not landed:
                    self.client._pending[h.req_id] = pend
            if landed:
                pend.label = h.label
                pend.latency_ms = h.latency_ms
                pend.error = h.error
                pend.retry_after_ms = h.retry_after_ms
                pend._event.set()

    def flush(self) -> None:
        """Ship every buffered row now, regardless of age or size."""
        with self._lock:
            pending = {t: self._take_locked(t)
                       for t in list(self._buffers)}
        for tenant, rows in pending.items():
            if rows:
                self._ship(tenant, rows)

    def _tick_loop(self) -> None:
        period_s = self.max_delay_ms * 1e-3 / 2
        while not self._wake.wait(period_s):
            now = time.monotonic()
            stale = []
            with self._lock:
                for tenant, t0 in list(self._oldest.items()):
                    if (now - t0) * 1e3 >= self.max_delay_ms:
                        stale.append((tenant, self._take_locked(tenant)))
            for tenant, rows in stale:
                if rows:
                    try:
                        self._ship(tenant, rows)
                    except FleetClientError:
                        pass        # _ship resolved the handles with errors

    def close(self, flush: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if flush:
            self.flush()
        self._wake.set()
        self._ticker.join(5.0)

    def __enter__(self) -> "CoalescingSubmitter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class UdpSwarmSender:
    """Fire-and-forget UDP ingest: datagrams out, nothing ever comes back.

    The connectionless half of the swarm story — a sensor that cannot
    hold a TCP connection (or afford its handshake) blasts SUBMIT /
    SUBMIT_BATCH payloads as raw datagrams at the server's UDP port.  No
    HELLO, no results, no ordering, no delivery guarantee: datagrams may
    be dropped by either kernel under load, and the server only counts
    what arrived (`udp` section of the STATS RPC).  Use TCP when every
    label matters; use this when the swarm's job is to saturate the
    fleet.  `max_datagram` bounds each payload (65507 is the loopback
    ceiling; ~1400 survives a real ethernet path without fragmenting).
    """

    def __init__(self, host: str, port: int, *, max_datagram: int = 65507):
        self.addr = (host, port)
        self.max_datagram = max_datagram
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
        self._next_id = 1
        self.n_sent = 0             # readings handed to the kernel

    def send(self, tenant: str, readings: np.ndarray,
             deadline_ms: float | None = None) -> None:
        """One reading as one SUBMIT datagram (strip the length prefix —
        the datagram boundary is the frame)."""
        payload = P.encode_submit(self._next_id, tenant, readings,
                                  deadline_ms)[4:]
        self._next_id += 1
        self._sock.sendto(payload, self.addr)
        self.n_sent += 1

    def send_many(self, tenant: str, x: np.ndarray,
                  deadlines_ms=None) -> int:
        """A `(B, F)` plane as SUBMIT_BATCH datagrams; returns rows sent.

        Chunked so each datagram (payload only, no length prefix) fits
        `max_datagram`.
        """
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
        if x.ndim != 2:
            raise ValueError(f"expected (B, F) readings, got {x.shape}")
        B = x.shape[0]
        dls = (None if deadlines_ms is None else
               np.broadcast_to(np.asarray(deadlines_ms, dtype=np.float64),
                               (B,)))
        # per-row cost: u64 req_id + f8 deadline + F f8 features
        head = 1 + 10 + len(tenant.encode())    # type + !HII head + name
        step = max(1, (self.max_datagram - head)
                   // (16 + 8 * x.shape[1]))
        sent = 0
        for s in range(0, B, step):
            e = min(B, s + step)
            rids = np.arange(self._next_id, self._next_id + (e - s),
                             dtype=np.uint64)
            self._next_id += e - s
            payload = P.encode_submit_batch(
                rids, tenant, x[s:e],
                None if dls is None else dls[s:e])[4:]
            self._sock.sendto(payload, self.addr)
            sent += e - s
        self.n_sent += sent
        return sent

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "UdpSwarmSender":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
