"""Asyncio socket front for a `ClassifierFleet`: sharded TCP + UDP ingest.

The port of `repro.serve.server`.  It speaks the reference's protocol
(`protocol.py`), so a client of either package is served alike; the LIST
row keeps the reference's keys, with the tenant's device name under
`"backend"`.

The server owns one running fleet and up to three kinds of transport
front ends:

* **Sharded TCP accept loops** — `shards=N` runs N worker threads, each
  with its own asyncio event loop and its own listening socket bound to
  the *same* port via ``SO_REUSEPORT``, so the kernel spreads incoming
  connections across loops and no single accept loop (or its event loop)
  becomes the choke point of a 10k-connection swarm.  Every connection is
  de-framed by `protocol.FrameReader`; v2 clients may ship whole
  `SUBMIT_BATCH` frames that enter the fleet through the
  `ClassifierFleet.submit_many` single-lock fast path.
* **Per-connection write coalescing** — completions are queued per
  connection as plain tuples; the writer task drains whatever is ready
  and, on a v2 connection, folds every ready completion into one
  `RESULT_BATCH` frame + one ``writer.write`` call, so a thousand labels
  cost one syscall instead of a thousand.
* **Connectionless UDP ingest** (`udp_port=`) — fire-and-forget mode for
  sensor swarms that cannot hold a TCP connection: each datagram is one
  SUBMIT or SUBMIT_BATCH payload (no length prefix — the datagram
  boundary is the frame), submitted into the fleet with no reply path.
  Delivery is best-effort (drops are the client's problem by design);
  the server counts datagrams/readings/sheds/errors in `udp_stats` and
  reports them through the STATS RPC so a firehose can verify receipt.

Protocol version negotiation happens at HELLO: the server answers
WELCOME with ``min(client_version, PROTOCOL_VERSION)`` and holds the
connection to that — a v1 client keeps its per-reading SUBMIT/RESULT
conversation, byte-compatible with the first wire format.

The fleet's dispatch threads hand finished requests to the owning
connection's event loop via `FleetRequest.add_done_callback` +
`loop.call_soon_threadsafe`, so no thread ever parks on a request and a
connection can pipeline thousands of readings.  Admission-control sheds
(`FleetOverloadError` / partial `submit_many` admission) become SHED
frames with the `retry_after_ms` hint; bad tenants / feature counts
become per-request ERROR frames; a protocol violation gets one
connection-level ERROR (`CONN_ERR`) and the connection is closed.
LIST/STATS/RELOAD are JSON-bodied admin round-trips (RELOAD runs
`fleet.sync_manifest()`).

With `watch_manifest=True` shard 0 also polls the emit dir's
`fleet.json` mtime + generation and hot-reloads added/replaced/retired
tenants without draining anything — the network half of the manifest
story (`compile/artifact.py` bumps the generation, the fleet reconciles).

The server runs either in the foreground (`python -m repro_torch.serve serve`)
or on background threads (`start_background()` — what the tests and the
cross-process CI smoke use); either way every shard is a plain
`asyncio.run` loop on its own daemon thread.
"""
from __future__ import annotations

import asyncio
import socket
import threading
from pathlib import Path

from repro_torch.compile.artifact import manifest_path
from repro_torch.serve import protocol as P
from repro_torch.serve.fleet import ClassifierFleet, FleetOverloadError

_CLOSE = None                   # writer-queue close sentinel


class _ConnState:
    """Per-connection context shared by the reader and writer halves."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.out_q: asyncio.Queue = asyncio.Queue()
        self.version = P.PROTOCOL_VERSION   # negotiated at HELLO

    def send_raw(self, data: bytes) -> None:
        self.out_q.put_nowait(("raw", data))

    def send_result(self, req_id: int, label: int,
                    latency_ms: float) -> None:
        self.out_q.put_nowait(("res", req_id, label, latency_ms))


class _UdpIngest(asyncio.DatagramProtocol):
    """Fire-and-forget ingest: one datagram = one SUBMIT/SUBMIT_BATCH."""

    def __init__(self, server: "FleetServer"):
        self.server = server

    def datagram_received(self, data: bytes, addr) -> None:
        stats = self.server.udp_stats
        stats["n_datagrams"] += 1
        fleet = self.server.fleet
        try:
            msg = P.decode_message(data)
            if msg.type == P.MSG_SUBMIT:
                stats["n_readings"] += 1
                fleet.submit(msg.tenant, msg.readings,
                             deadline_ms=msg.deadline_ms)
                stats["n_admitted"] += 1
            elif msg.type == P.MSG_SUBMIT_BATCH:
                stats["n_readings"] += msg.readings.shape[0]
                reqs, shed_idx, _ = fleet.submit_many(
                    msg.tenant, msg.readings, msg.deadlines_ms)
                stats["n_admitted"] += len(reqs)
                stats["n_shed"] += len(shed_idx)
            else:
                stats["n_errors"] += 1
        except FleetOverloadError:
            stats["n_shed"] += 1
        except Exception:       # garbage datagram / bad tenant: drop, count
            stats["n_errors"] += 1


class FleetServer:
    """Socket transport + lifecycle around one running fleet."""

    def __init__(self, fleet: ClassifierFleet, host: str = "127.0.0.1",
                 port: int = 0, *, shards: int = 1,
                 udp_port: int | None = None, watch_manifest: bool = False,
                 watch_interval_s: float = 0.5):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.fleet = fleet
        self.host = host
        self.port = port
        self.shards = shards
        self.udp_port = udp_port
        self.watch_manifest = watch_manifest
        self.watch_interval_s = watch_interval_s
        self.address: tuple[str, int] | None = None
        self.udp_address: tuple[str, int] | None = None
        self.reloads: list[dict] = []       # sync_manifest action records
        self.n_connections = 0
        self.udp_stats = {"n_datagrams": 0, "n_readings": 0,
                          "n_admitted": 0, "n_shed": 0, "n_errors": 0}
        self._count_lock = threading.Lock()
        self._socks: list[socket.socket] = []
        self._udp_sock: socket.socket | None = None
        self._loops: list[asyncio.AbstractEventLoop | None] = []
        self._stops: list[asyncio.Event | None] = []
        self._threads: list[threading.Thread] = []
        self._ready: list[threading.Event] = []
        self._startup_exc: BaseException | None = None

    # -- tenant table (LIST) -------------------------------------------------
    def _tenant_rows(self) -> list[dict]:
        rows = []
        for name in self.fleet.tenants:
            t = self.fleet._tenant(name)
            rows.append({
                "name": name,
                "n_features": t.engine.n_features,
                "n_classes": t.engine.program.n_classes,
                "backend": t.device_key,
                "deadline_ms": t.spec.deadline_ms,
                "max_batch": t.spec.max_batch,
                "max_queue": t.spec.max_queue,
                "replicas": t.pool.size,
                "dataset": t.spec.dataset,
                "generation": t.spec.generation,
                "sha256": t.spec.sha256,
                "qos": t.spec.qos,
                "rate_limit_rps": t.spec.rate_limit_rps,
                "shadow": (self.fleet._shadows[name].name
                           if name in self.fleet._shadows else None),
            })
        return rows

    def _stats_doc(self) -> dict:
        # stats_summary already carries the controller sections when armed:
        # "workers" (per-device subprocess hosts + slab ring) and
        # "autoscale" (round counter + recent scale events)
        doc = self.fleet.stats_summary()
        doc["transport"] = {
            "shards": self.shards,
            "n_connections": self.n_connections,
            "worker_procs": self.fleet.workers,
            "udp": (dict(self.udp_stats)
                    if self.udp_address is not None else None),
        }
        return doc

    # -- socket binding ------------------------------------------------------
    def _bind_sockets(self) -> None:
        """Bind all shard listeners (and the UDP socket) up front.

        With more than one shard every listener sets ``SO_REUSEPORT`` and
        binds the same port, so the kernel load-balances accepts across
        the shard loops.  Binding before any thread starts means a
        ``port=0`` ephemeral pick is resolved once and shared.
        """
        port = self.port
        for i in range(self.shards):
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if self.shards > 1:
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
                sock.bind((self.host, port))
                sock.listen(4096)
                sock.setblocking(False)
            except BaseException:
                sock.close()
                raise
            if i == 0:
                port = sock.getsockname()[1]
                self.address = sock.getsockname()[:2]
            self._socks.append(sock)
        if self.udp_port is not None:
            usock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                usock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 1 << 22)
                usock.bind((self.host, self.udp_port))
                usock.setblocking(False)
            except BaseException:
                usock.close()
                raise
            self.udp_address = usock.getsockname()[:2]
            self._udp_sock = usock

    # -- per-connection plumbing ---------------------------------------------
    async def _writer_loop(self, writer: asyncio.StreamWriter,
                           conn: _ConnState) -> None:
        out_q = conn.out_q
        closing = False
        while not closing:
            items = [await out_q.get()]
            while True:     # coalesce whatever else is ready into one write
                try:
                    items.append(out_q.get_nowait())
                except asyncio.QueueEmpty:
                    break
            if _CLOSE in items:     # close sentinel — may arrive mid-burst
                closing = True      # (a dispatch completing after the
                items = [it for it in items if it is not _CLOSE]  # disconnect)
            chunks, results = [], []
            for it in items:
                if it[0] == "raw":
                    chunks.append(it[1])
                else:
                    results.append(it[1:])
            if results:
                if conn.version >= 2 and len(results) > 1:
                    rids, labels, lats = zip(*results)
                    chunks.append(P.encode_result_batch(rids, labels, lats))
                else:
                    chunks.extend(P.encode_result(*r) for r in results)
            if chunks:
                writer.write(b"".join(chunks))
                try:
                    await writer.drain()
                except (ConnectionError, OSError):
                    return

    def _completion_callback(self, req_id: int, conn: _ConnState):
        """Bridge a fleet dispatch thread back onto this connection's loop."""

        def on_done(freq) -> None:
            try:
                if freq.error is not None:
                    conn.loop.call_soon_threadsafe(
                        conn.send_raw, P.encode_error(req_id, freq.error))
                else:
                    conn.loop.call_soon_threadsafe(
                        conn.send_result, req_id, freq.label,
                        freq.latency_ms)
            except RuntimeError:
                pass        # loop already closed; connection is gone anyway

        return on_done

    def _handle_submit_batch(self, msg: P.Message, conn: _ConnState) -> None:
        """One SUBMIT_BATCH frame -> the fleet's single-lock fast path."""
        try:
            reqs, shed_idx, retry_ms = self.fleet.submit_many(
                msg.tenant, msg.readings, msg.deadlines_ms)
        except (KeyError, ValueError, RuntimeError) as exc:
            err = str(exc)
            for rid in msg.req_ids:     # fail every row loudly, none hang
                conn.send_raw(P.encode_error(int(rid), err))
            return
        for req, rid in zip(reqs, msg.req_ids):
            req.add_done_callback(self._completion_callback(int(rid), conn))
        for i in shed_idx:
            conn.send_raw(P.encode_shed(int(msg.req_ids[i]), retry_ms))

    async def _handle_message(self, msg: P.Message,
                              conn: _ConnState) -> None:
        if msg.type == P.MSG_SUBMIT:
            try:
                req = self.fleet.submit(msg.tenant, msg.readings,
                                        deadline_ms=msg.deadline_ms)
            except FleetOverloadError as exc:
                conn.send_raw(P.encode_shed(msg.req_id, exc.retry_after_ms))
                return
            except (KeyError, ValueError, RuntimeError) as exc:
                conn.send_raw(P.encode_error(msg.req_id, str(exc)))
                return
            req.add_done_callback(self._completion_callback(msg.req_id,
                                                            conn))
        elif msg.type == P.MSG_SUBMIT_BATCH:
            self._handle_submit_batch(msg, conn)
        elif msg.type == P.MSG_LIST:
            conn.send_raw(P.encode_tenants(self._tenant_rows()))
        elif msg.type == P.MSG_STATS:
            conn.send_raw(P.encode_stats_reply(self._stats_doc()))
        elif msg.type == P.MSG_RELOAD:
            actions = await asyncio.get_running_loop().run_in_executor(
                None, self.fleet.sync_manifest)
            self.reloads.append(actions)
            conn.send_raw(P.encode_reloaded(actions))
        else:
            raise P.ProtocolError(f"unexpected message type {msg.type}")

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        conn = _ConnState(asyncio.get_running_loop())
        wtask = asyncio.ensure_future(self._writer_loop(writer, conn))
        framer = P.FrameReader()
        with self._count_lock:
            self.n_connections += 1
        greeted = False
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    break
                for payload in framer.feed(chunk):
                    msg = P.decode_message(payload)
                    if not greeted:
                        if msg.type != P.MSG_HELLO:
                            raise P.ProtocolError(
                                "first message must be HELLO")
                        conn.version = P.negotiate_version(msg.version)
                        conn.send_raw(P.encode_welcome(conn.version))
                        greeted = True
                        continue
                    await self._handle_message(msg, conn)
        except P.ProtocolError as exc:
            conn.send_raw(P.encode_error(P.CONN_ERR, str(exc)))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.out_q.put_nowait(_CLOSE)
            await wtask
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- manifest watcher ----------------------------------------------------
    async def _watch_manifest(self) -> None:
        ctx = self.fleet._manifest_ctx
        if ctx is None:
            return
        path: Path = manifest_path(ctx["emit_dir"])
        loop = asyncio.get_running_loop()
        # baseline 0, not the current mtime: an emit that landed between
        # fleet load and watcher start must trigger the first sync (a
        # clean first poll just runs one no-op reconcile)
        last_mtime = 0
        while True:
            await asyncio.sleep(self.watch_interval_s)
            try:
                mtime = path.stat().st_mtime_ns
            except OSError:
                continue
            if mtime == last_mtime:
                continue
            last_mtime = mtime
            try:
                actions = await loop.run_in_executor(
                    None, self.fleet.sync_manifest)
            except Exception as exc:    # a half-written emit: retry next poll
                print(f"[serve] manifest sync failed: {exc}", flush=True)
                continue
            if any(actions[k] for k in ("added", "replaced", "retired")):
                self.reloads.append(actions)
                print(f"[serve] manifest gen {actions['generation']}: "
                      f"+{actions['added']} ~{actions['replaced']} "
                      f"-{actions['retired']}", flush=True)

    # -- lifecycle -----------------------------------------------------------
    async def _shard_main(self, idx: int, sock: socket.socket) -> None:
        """One shard: its own loop, its own listener (shard 0 also owns the
        manifest watcher and the UDP ingest endpoint)."""
        loop = asyncio.get_running_loop()
        self._loops[idx] = loop
        self._stops[idx] = stop = asyncio.Event()
        extras = []
        udp_transport = None
        try:
            server = await asyncio.start_server(self._handle_connection,
                                                sock=sock)
        except BaseException as exc:
            self._startup_exc = exc
            self._ready[idx].set()
            raise
        if idx == 0:
            if self.watch_manifest:
                extras.append(asyncio.ensure_future(self._watch_manifest()))
            if self._udp_sock is not None:
                udp_transport, _ = await loop.create_datagram_endpoint(
                    lambda: _UdpIngest(self), sock=self._udp_sock)
        self._ready[idx].set()
        try:
            async with server:
                await stop.wait()
        finally:
            for task in extras:
                task.cancel()
            if udp_transport is not None:
                udp_transport.close()

    def start_background(self) -> tuple[str, int]:
        """Bind, run every shard on a daemon thread; returns the address."""
        self._bind_sockets()
        self._loops = [None] * self.shards
        self._stops = [None] * self.shards
        self._ready = [threading.Event() for _ in range(self.shards)]
        for i, sock in enumerate(self._socks):
            th = threading.Thread(
                target=lambda i=i, sock=sock: asyncio.run(
                    self._shard_main(i, sock)),
                name=f"fleet-server-{i}", daemon=True)
            self._threads.append(th)
            th.start()
        for ev in self._ready:
            if not ev.wait(30.0):
                raise TimeoutError("fleet server did not come up within 30s")
        if self._startup_exc is not None:
            raise self._startup_exc
        return self.address

    def stop(self, timeout: float = 30.0) -> None:
        """Stop serving (background-thread mode); the fleet stays up."""
        for loop, stop in zip(self._loops, self._stops):
            if loop is None or stop is None:
                continue
            try:
                loop.call_soon_threadsafe(stop.set)
            except RuntimeError:
                continue                     # loop already gone
        for th in self._threads:
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError(f"fleet server thread {th.name} did not "
                                   f"stop within {timeout}s")
        self._threads = []


def serve_forever(fleet: ClassifierFleet, host: str, port: int, *,
                  shards: int = 1, udp_port: int | None = None,
                  watch_manifest: bool = False) -> None:
    """Foreground entry point for the CLI: serve until KeyboardInterrupt."""
    server = FleetServer(fleet, host, port, shards=shards,
                         udp_port=udp_port, watch_manifest=watch_manifest)
    try:
        h, p = server.start_background()
        udp = (f", udp ingest on {server.udp_address[0]}:"
               f"{server.udp_address[1]}" if server.udp_address else "")
        print(f"[serve] fleet of {len(fleet.tenants)} tenant(s) "
              f"listening on {h}:{p} x{shards} shard(s){udp} "
              f"(watch={'on' if watch_manifest else 'off'})", flush=True)
        threading.Event().wait()            # park until interrupted
    except KeyboardInterrupt:
        print("[serve] interrupted; draining fleet", flush=True)
        server.stop()
    finally:
        fleet.shutdown(drain=True)
