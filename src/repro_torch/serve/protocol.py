"""Length-prefixed binary wire protocol for the sensor-serving fleet.

The port's copy of `repro.serve.protocol`, byte for byte on the wire, so
a client of either package talks to a server of the other.  The transport
half of the fleet's network front: pure
bytes-in/bytes-out framing + message codecs with no sockets, threads or
asyncio in them, shared verbatim by the asyncio server (`server.py`) and
the blocking client (`client.py`) — and therefore drivable by hypothesis
through arbitrary chunkings without either endpoint in the loop.

Framing: every message is ``!I`` payload length (big-endian u32, length
of the payload only) followed by the payload; payload byte 0 is the
message type, the rest is type-specific fixed `struct` fields + raw
bodies.  Sensor readings travel as raw little-endian float64 — the same
bytes `np.float64.tobytes()` produces on every platform we serve from —
so a reading crosses the wire without any text encode/decode on the hot
path.  A 64 MiB frame cap bounds memory against a corrupt or hostile
length prefix.

Conversation:

  client  ──HELLO──▶  server          magic + highest version it speaks
  client  ◀─WELCOME── server          negotiated version (min of the two)
  client  ──SUBMIT──▶ server          req_id, tenant, deadline, readings
  client  ──SUBMIT_BATCH──▶ server    v2: many readings in one frame
  client  ◀─RESULT──  server          req_id, label, server latency
  client  ◀─RESULT_BATCH── server     v2: many completions in one frame
  client  ◀─SHED────  server          req_id, retry_after_ms  (admission)
  client  ◀─ERROR───  server          req_id (or CONN_ERR), message
  client  ──LIST/STATS/RELOAD──▶      JSON-bodied admin round-trips

RESULT/SHED/ERROR stream back in completion order, not submit order —
req_ids are the correlation, so a client may pipeline arbitrarily many
SUBMITs before reading anything back.

**Version negotiation** (v2): HELLO carries the highest version the
client speaks; the server answers WELCOME with ``min(client, server)``
and both sides hold to that for the rest of the connection.  A v1 client
(HELLO version 1) therefore keeps working against a v2 server — it is
answered with WELCOME version 1 and only ever sees v1 frames.

**Batch frames** (v2): `SUBMIT_BATCH` amortizes framing + syscall +
event-loop cost over a whole sensor batch — one contiguous little-endian
float64 ``(B, F)`` reading plane prefixed by a packed per-row req_id
(u64) and deadline (f8, NaN = tenant default) table.  `RESULT_BATCH` is
the mirror image for completions (req_id/label/latency tables).  Both
stay inside the 64 MiB frame cap: `encode_submit_batch` refuses larger
planes (`batch_rows_per_frame` tells a sender how to chunk).
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

PROTOCOL_MAGIC = b"RSRV"
PROTOCOL_VERSION = 2            # highest version this codec speaks
MIN_PROTOCOL_VERSION = 1        # oldest version still negotiable
MAX_FRAME = 64 << 20            # hard cap on one payload (corruption guard)
CONN_ERR = 0xFFFFFFFFFFFFFFFF   # req_id of a connection-level ERROR

MSG_HELLO = 1
MSG_WELCOME = 2
MSG_SUBMIT = 3
MSG_RESULT = 4
MSG_SHED = 5
MSG_ERROR = 6
MSG_LIST = 7
MSG_TENANTS = 8
MSG_STATS = 9
MSG_STATS_REPLY = 10
MSG_RELOAD = 11
MSG_RELOADED = 12
MSG_SUBMIT_BATCH = 13           # v2
MSG_RESULT_BATCH = 14           # v2

_LEN = struct.Struct("!I")
_HELLO = struct.Struct("!4sB")          # magic, version
_SUBMIT_HEAD = struct.Struct("!QdHI")   # req_id, deadline_ms, name_len, n_feat
_RESULT = struct.Struct("!Qid")         # req_id, label, latency_ms
_SHED = struct.Struct("!Qd")            # req_id, retry_after_ms
_ERROR_HEAD = struct.Struct("!QH")      # req_id, msg_len
_SUBMIT_BATCH_HEAD = struct.Struct("!HII")   # name_len, n_rows, n_feat
_RESULT_BATCH_HEAD = struct.Struct("!I")     # n_rows
_ROW_TABLE_BYTES = 8 + 8        # per-row req_id (u64) + deadline (f8)


class ProtocolError(RuntimeError):
    """Malformed frame / bad magic / version mismatch / oversized payload."""


def frame(payload: bytes) -> bytes:
    """Wrap one payload in its length prefix."""
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"payload of {len(payload)} bytes exceeds the "
                            f"{MAX_FRAME}-byte frame cap")
    return _LEN.pack(len(payload)) + payload


# -- encoders ---------------------------------------------------------------
def encode_hello(version: int = PROTOCOL_VERSION) -> bytes:
    return frame(bytes([MSG_HELLO]) + _HELLO.pack(PROTOCOL_MAGIC, version))


def encode_welcome(version: int = PROTOCOL_VERSION) -> bytes:
    return frame(bytes([MSG_WELCOME]) + _HELLO.pack(PROTOCOL_MAGIC, version))


def negotiate_version(client_version: int) -> int:
    """The version a server holds the connection to (raises if hopeless)."""
    if client_version < MIN_PROTOCOL_VERSION:
        raise ProtocolError(f"protocol version {client_version} is older "
                            f"than the oldest supported "
                            f"({MIN_PROTOCOL_VERSION})")
    return min(client_version, PROTOCOL_VERSION)


def encode_submit(req_id: int, tenant: str, readings: np.ndarray,
                  deadline_ms: float | None = None) -> bytes:
    """One sensor reading: header + tenant utf8 + raw LE float64 features.

    `deadline_ms=None` (encoded as NaN) means "use the tenant's configured
    budget" — the one float value a budget can never legitimately be.
    """
    name = tenant.encode()
    x = np.ascontiguousarray(np.asarray(readings, dtype="<f8").reshape(-1))
    head = _SUBMIT_HEAD.pack(
        req_id, float("nan") if deadline_ms is None else float(deadline_ms),
        len(name), x.shape[0])
    return frame(bytes([MSG_SUBMIT]) + head + name + x.tobytes())


def batch_rows_per_frame(n_feat: int, max_frame: int = MAX_FRAME) -> int:
    """How many readings of `n_feat` features fit in one SUBMIT_BATCH frame.

    Senders chunk a larger plane into this many rows per frame; the
    tenant-name bytes are bounded by the u16 length field, so budgeting
    for the worst case keeps the arithmetic name-independent.
    """
    budget = max_frame - 1 - _SUBMIT_BATCH_HEAD.size - 65535
    return max(1, budget // (_ROW_TABLE_BYTES + 8 * n_feat))


def encode_submit_batch(req_ids, tenant: str, plane: np.ndarray,
                        deadlines_ms=None) -> bytes:
    """Many readings in one frame: header + tenant + row tables + f8 plane.

    `plane` is ``(B, F)`` float64 (any input convertible to it); `req_ids`
    is one u64 per row; `deadlines_ms` is None (all rows use the tenant's
    configured budget), a scalar, or one float per row — NaN rows fall
    back to the tenant default, exactly like v1 SUBMIT.
    """
    plane = np.ascontiguousarray(np.asarray(plane, dtype="<f8"))
    if plane.ndim != 2:
        raise ProtocolError(f"submit batch plane must be (B, F), "
                            f"got shape {plane.shape}")
    n_rows, n_feat = plane.shape
    rids = np.ascontiguousarray(np.asarray(req_ids, dtype="<u8").reshape(-1))
    if rids.shape[0] != n_rows:
        raise ProtocolError(f"{rids.shape[0]} req_ids for {n_rows} rows")
    if deadlines_ms is None:
        dls = np.full(n_rows, np.nan, dtype="<f8")
    else:
        dls = np.ascontiguousarray(
            np.broadcast_to(np.asarray(deadlines_ms, dtype="<f8"),
                            (n_rows,)))
    name = tenant.encode()
    if len(name) > 65535:
        raise ProtocolError("tenant name exceeds 65535 bytes")
    head = _SUBMIT_BATCH_HEAD.pack(len(name), n_rows, n_feat)
    return frame(b"".join((bytes([MSG_SUBMIT_BATCH]), head, name,
                           rids.tobytes(), dls.tobytes(), plane.tobytes())))


def encode_result(req_id: int, label: int, latency_ms: float) -> bytes:
    return frame(bytes([MSG_RESULT])
                 + _RESULT.pack(req_id, int(label), float(latency_ms)))


def encode_result_batch(req_ids, labels, latencies_ms) -> bytes:
    """Many completions in one frame: req_id/label/latency row tables."""
    rids = np.ascontiguousarray(np.asarray(req_ids, dtype="<u8").reshape(-1))
    lbls = np.ascontiguousarray(np.asarray(labels, dtype="<i4").reshape(-1))
    lats = np.ascontiguousarray(np.asarray(latencies_ms,
                                           dtype="<f8").reshape(-1))
    if not (rids.shape == lbls.shape == lats.shape):
        raise ProtocolError("result batch tables disagree on length")
    head = _RESULT_BATCH_HEAD.pack(rids.shape[0])
    return frame(b"".join((bytes([MSG_RESULT_BATCH]), head, rids.tobytes(),
                           lbls.tobytes(), lats.tobytes())))


def encode_shed(req_id: int, retry_after_ms: float) -> bytes:
    return frame(bytes([MSG_SHED]) + _SHED.pack(req_id, float(retry_after_ms)))


def encode_error(req_id: int, message: str) -> bytes:
    msg = message.encode()[:65535]
    return frame(bytes([MSG_ERROR]) + _ERROR_HEAD.pack(req_id, len(msg)) + msg)


def _encode_json(msg_type: int, doc) -> bytes:
    return frame(bytes([msg_type]) + json.dumps(doc, sort_keys=True).encode())


def encode_list() -> bytes:
    return frame(bytes([MSG_LIST]))


def encode_tenants(rows: list[dict]) -> bytes:
    return _encode_json(MSG_TENANTS, rows)


def encode_stats() -> bytes:
    return frame(bytes([MSG_STATS]))


def encode_stats_reply(summary: dict) -> bytes:
    return _encode_json(MSG_STATS_REPLY, summary)


def encode_reload() -> bytes:
    return frame(bytes([MSG_RELOAD]))


def encode_reloaded(actions: dict) -> bytes:
    return _encode_json(MSG_RELOADED, actions)


# -- decoder ----------------------------------------------------------------
@dataclass
class Message:
    """One decoded payload: `type` + the type-specific fields as attrs."""

    type: int
    req_id: int = 0
    tenant: str = ""
    readings: np.ndarray | None = None      # (F,) v1 submit; (B, F) v2 batch
    deadline_ms: float | None = None
    label: int = 0
    latency_ms: float = 0.0
    retry_after_ms: float = 0.0
    message: str = ""
    doc: object = None
    version: int = PROTOCOL_VERSION         # HELLO/WELCOME payload version
    req_ids: np.ndarray | None = None       # (B,) u64, batch frames
    deadlines_ms: np.ndarray | None = None  # (B,) f8 (NaN = tenant default)
    labels: np.ndarray | None = None        # (B,) i4, RESULT_BATCH
    latencies_ms: np.ndarray | None = None  # (B,) f8, RESULT_BATCH


def _need(payload: bytes, n: int, what: str) -> None:
    if len(payload) < n:
        raise ProtocolError(f"truncated {what}: {len(payload)} < {n} bytes")


def decode_message(payload: bytes) -> Message:
    """Decode one de-framed payload (raises `ProtocolError` on garbage)."""
    _need(payload, 1, "payload")
    mtype, body = payload[0], payload[1:]
    if mtype in (MSG_HELLO, MSG_WELCOME):
        _need(body, _HELLO.size, "hello")
        magic, version = _HELLO.unpack_from(body)
        if magic != PROTOCOL_MAGIC:
            raise ProtocolError(f"bad magic {magic!r} (not a repro.serve "
                                "endpoint?)")
        if not MIN_PROTOCOL_VERSION <= version <= PROTOCOL_VERSION:
            raise ProtocolError(
                f"protocol version {version} outside the supported range "
                f"[{MIN_PROTOCOL_VERSION}, {PROTOCOL_VERSION}]")
        return Message(type=mtype, version=version)
    if mtype == MSG_SUBMIT:
        _need(body, _SUBMIT_HEAD.size, "submit header")
        req_id, deadline_ms, name_len, n_feat = _SUBMIT_HEAD.unpack_from(body)
        off = _SUBMIT_HEAD.size
        _need(body, off + name_len + 8 * n_feat, "submit body")
        try:
            tenant = body[off: off + name_len].decode()
        except UnicodeDecodeError as exc:
            raise ProtocolError(f"submit tenant name is not UTF-8: "
                                f"{exc}") from exc
        off += name_len
        readings = np.frombuffer(body, dtype="<f8", count=n_feat,
                                 offset=off).astype(np.float64)
        return Message(type=mtype, req_id=req_id, tenant=tenant,
                       readings=readings,
                       deadline_ms=(None if np.isnan(deadline_ms)
                                    else float(deadline_ms)))
    if mtype == MSG_SUBMIT_BATCH:
        _need(body, _SUBMIT_BATCH_HEAD.size, "submit batch header")
        name_len, n_rows, n_feat = _SUBMIT_BATCH_HEAD.unpack_from(body)
        off = _SUBMIT_BATCH_HEAD.size
        need = off + name_len + n_rows * (_ROW_TABLE_BYTES + 8 * n_feat)
        _need(body, need, "submit batch body")
        try:
            tenant = body[off: off + name_len].decode()
        except UnicodeDecodeError as exc:
            raise ProtocolError(f"submit batch tenant name is not UTF-8: "
                                f"{exc}") from exc
        off += name_len
        req_ids = np.frombuffer(body, dtype="<u8", count=n_rows, offset=off)
        off += 8 * n_rows
        deadlines = np.frombuffer(body, dtype="<f8", count=n_rows,
                                  offset=off).astype(np.float64)
        off += 8 * n_rows
        plane = np.frombuffer(body, dtype="<f8", count=n_rows * n_feat,
                              offset=off).astype(np.float64)
        return Message(type=mtype, tenant=tenant,
                       req_ids=req_ids.astype(np.uint64),
                       deadlines_ms=deadlines,
                       readings=plane.reshape(n_rows, n_feat))
    if mtype == MSG_RESULT_BATCH:
        _need(body, _RESULT_BATCH_HEAD.size, "result batch header")
        (n_rows,) = _RESULT_BATCH_HEAD.unpack_from(body)
        off = _RESULT_BATCH_HEAD.size
        _need(body, off + n_rows * (8 + 4 + 8), "result batch body")
        req_ids = np.frombuffer(body, dtype="<u8", count=n_rows, offset=off)
        off += 8 * n_rows
        labels = np.frombuffer(body, dtype="<i4", count=n_rows, offset=off)
        off += 4 * n_rows
        lats = np.frombuffer(body, dtype="<f8", count=n_rows, offset=off)
        return Message(type=mtype, req_ids=req_ids.astype(np.uint64),
                       labels=labels.astype(np.int32),
                       latencies_ms=lats.astype(np.float64))
    if mtype == MSG_RESULT:
        _need(body, _RESULT.size, "result")
        req_id, label, latency_ms = _RESULT.unpack_from(body)
        return Message(type=mtype, req_id=req_id, label=label,
                       latency_ms=latency_ms)
    if mtype == MSG_SHED:
        _need(body, _SHED.size, "shed")
        req_id, retry_after_ms = _SHED.unpack_from(body)
        return Message(type=mtype, req_id=req_id,
                       retry_after_ms=retry_after_ms)
    if mtype == MSG_ERROR:
        _need(body, _ERROR_HEAD.size, "error header")
        req_id, msg_len = _ERROR_HEAD.unpack_from(body)
        _need(body, _ERROR_HEAD.size + msg_len, "error body")
        # "replace", not strict: an error report must never itself become
        # undecodable (encode_error's byte-level truncation can split a
        # multibyte character)
        msg = body[_ERROR_HEAD.size: _ERROR_HEAD.size + msg_len].decode(
            errors="replace")
        return Message(type=mtype, req_id=req_id, message=msg)
    if mtype in (MSG_LIST, MSG_STATS, MSG_RELOAD):
        return Message(type=mtype)
    if mtype in (MSG_TENANTS, MSG_STATS_REPLY, MSG_RELOADED):
        try:
            doc = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ProtocolError(f"bad JSON body in message type {mtype}: "
                                f"{exc}") from exc
        return Message(type=mtype, doc=doc)
    raise ProtocolError(f"unknown message type {mtype}")


class FrameReader:
    """Incremental de-framer: feed byte chunks, collect complete payloads.

    Chunk boundaries are arbitrary (a TCP stream guarantees nothing about
    them), so the reader buffers until a full length-prefixed frame is in
    and yields exactly the payload bytes — pinned against random
    re-chunkings by the protocol property test.
    """

    def __init__(self, max_frame: int = MAX_FRAME):
        self.max_frame = max_frame
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf.extend(chunk)
        out = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (length,) = _LEN.unpack_from(self._buf)
            if length > self.max_frame:
                raise ProtocolError(f"frame of {length} bytes exceeds the "
                                    f"{self.max_frame}-byte cap")
            if len(self._buf) < _LEN.size + length:
                return out
            out.append(bytes(self._buf[_LEN.size: _LEN.size + length]))
            del self._buf[: _LEN.size + length]

    @property
    def buffered(self) -> int:
        return len(self._buf)
