"""Process-per-device dispatch workers fed by shared-memory reading planes.

The port of `repro.serve.workers`, with the device in place of the
backend name.  In-process, every replica's dispatch shares the fleet
process's interpreter lock: the binarize, pack and label copy-back of one
batch wait for another's.  This module moves *dispatch only* out of
process:

  * the scheduler, admission control, micro-batching and stats stay in
    the fleet process (single-threaded-ish, lock-simple);
  * each device gets a `WorkerHost` owning N spawned subprocesses, each
    holding its own `CircuitServingEngine` per loaded tenant on that
    device (its own interpreter and, on a card, its own CUDA context and
    copy of the kernel library);
  * reading planes cross the process boundary through a ring of
    `multiprocessing.shared_memory` slabs: the fleet writes the gathered
    ``(B, F)`` float64 plane into a slab, ships only the slab *name* and
    shape over a task queue, and the worker writes the ``(B,)`` int32
    label plane back into the same slab — request/response queues carry
    tens of bytes regardless of batch size.

Slab layout: input plane at offset 0 (``B*F*8`` bytes, so the label
region at offset ``B*F*8`` is always 8-aligned), labels directly after.
Slabs are pooled: `acquire` reuses the smallest free slab that fits and
allocates on demand, so the ring grows to peak dispatch concurrency and
no further.  The fleet side owns every slab's lifetime (create + unlink);
workers attach lazily by name and cache the mapping.

Workers start from the `spawn` context only: forking a process whose CUDA
runtime is initialised is not allowed.  On a card the host builds the
kernel library before it spawns anything (`kernels._build.build`, keyed by
content), so N children load one library instead of running nvcc at once.

Failure model: a worker that dies mid-dispatch fails its in-flight evals
with `WorkerError` (the fleet completes those requests exceptionally,
exactly like an in-process dispatch error) and is respawned with all
tenant programs re-broadcast.  Timeouts are treated the same way, except the slab a late
worker might still scribble on is quarantined until host close instead
of returning to the ring.

Replies travel over one pipe *per worker*, never a shared queue: a
worker killed mid-write (crash, OOM, terminate) can tear its own frame,
and on a shared channel that one partial write desyncs every other
worker's replies too — the collector would hang on garbage while
perfectly healthy workers keep answering into the void.  With a
single-writer pipe the blast radius is the dead worker alone: its pipe
raises/EOFs, its pendings fail fast, it respawns on a fresh pipe.
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from multiprocessing import get_context
from multiprocessing import shared_memory as _shm
from multiprocessing.connection import wait as _wait_ready

import numpy as np

from repro_torch.device import resolve_device

DEFAULT_SLAB_BYTES = 1 << 20
_CTX = get_context("spawn")     # fleet process has threads; fork is unsafe


class WorkerError(RuntimeError):
    """A worker-side dispatch failed (error, death, or timeout)."""


def _attach_slab(name: str) -> _shm.SharedMemory:
    """Attach to a fleet-owned slab without confusing the resource tracker.

    On Python >= 3.13 `track=False` says what we mean: the fleet process
    is the sole owner and unlinks on close.  Older interpreters register
    the attach too — but spawn children share the parent's resource
    tracker process, so that register is a set-add of an already-tracked
    name and harmless; explicitly unregistering here would instead erase
    the *parent's* registration and make its unlink warn.
    """
    try:
        return _shm.SharedMemory(name=name, track=False)
    except TypeError:
        return _shm.SharedMemory(name=name)


def _worker_main(wid: int, n_procs: int, task_q, result_c) -> None:
    """Worker child entry point (module-level: spawn must pickle it).

    Ops arrive as tuples on the dedicated task queue; every op that has a
    `seq` answers on this worker's own result pipe as ``("ack"|"ok"|"err",
    wid, seq, payload)``.  Threads are capped before the engines import.
    """
    from repro_torch.kernels.dispatch import configure_worker_process
    configure_worker_process(n_procs)

    from repro_torch.compile.program import CircuitProgram
    from repro_torch.serve.engine import CircuitServingEngine

    engines: dict[str, CircuitServingEngine] = {}
    slabs: dict[str, _shm.SharedMemory] = {}
    result_c.send(("hello", wid, None, None))
    try:
        while True:
            msg = task_q.get()
            op = msg[0]
            if op == "stop":
                break
            if op == "unload":
                engines.pop(msg[1], None)
                continue
            seq = msg[1]
            try:
                if op == "load":
                    _, _, key, blob = msg
                    spec = pickle.loads(blob)
                    program = CircuitProgram(
                        ir=spec["ir"], thresholds=spec["thresholds"],
                        n_classes=spec["n_classes"], device=spec["device"])
                    engines[key] = CircuitServingEngine(
                        program, spec["max_batch"])
                    result_c.send(("ack", wid, seq, None))
                elif op == "warmup":
                    _, _, key = msg
                    dt = engines[key].warmup()
                    result_c.send(("ack", wid, seq, dt))
                elif op == "eval":
                    _, _, key, slab_name, B, F = msg
                    engine = engines.get(key)
                    if engine is None:
                        raise KeyError(f"tenant {key!r} not loaded in "
                                       f"worker {wid}")
                    shm = slabs.get(slab_name)
                    if shm is None:
                        shm = slabs[slab_name] = _attach_slab(slab_name)
                    x = np.ndarray((B, F), dtype=np.float64, buffer=shm.buf)
                    t0 = time.perf_counter()
                    labels = engine.classify_batch(x)
                    dt = time.perf_counter() - t0
                    out = np.ndarray((B,), dtype=np.int32, buffer=shm.buf,
                                     offset=B * F * 8)
                    out[:] = labels
                    del x, out
                    result_c.send(("ok", wid, seq, dt))
                elif op == "launches":
                    from repro_torch.kernels import cuda_circuit_sim as CK
                    result_c.send(("ok", wid, seq, {
                        "launches": dict(CK.LAUNCHES),
                        "by_variant": dict(CK.VARIANT_LAUNCHES)}))
                else:
                    raise ValueError(f"unknown worker op {op!r}")
            except Exception as exc:            # noqa: BLE001 — report, don't die
                result_c.send(("err", wid, seq,
                               f"{type(exc).__name__}: {exc}"))
    finally:
        for shm in slabs.values():
            try:
                shm.close()
            except Exception:
                pass


@dataclass
class _Slab:
    shm: _shm.SharedMemory
    capacity: int

    @property
    def name(self) -> str:
        return self.shm.name


class SlabRing:
    """Fleet-owned pool of shared-memory slabs, grown to peak concurrency."""

    def __init__(self, default_bytes: int = DEFAULT_SLAB_BYTES):
        self._lock = threading.Lock()
        self._free: list[_Slab] = []
        self._all: list[_Slab] = []
        self._default = int(default_bytes)
        self._closed = False

    def acquire(self, nbytes: int) -> _Slab:
        with self._lock:
            if self._closed:
                raise WorkerError("slab ring is closed")
            fits = [s for s in self._free if s.capacity >= nbytes]
            if fits:
                slab = min(fits, key=lambda s: s.capacity)
                self._free.remove(slab)
                return slab
            slab = _Slab(_shm.SharedMemory(
                create=True, size=max(nbytes, self._default)),
                capacity=max(nbytes, self._default))
            self._all.append(slab)
            return slab

    def release(self, slab: _Slab) -> None:
        with self._lock:
            if not self._closed:
                self._free.append(slab)

    def quarantine(self, slab: _Slab) -> None:
        """Never reuse `slab` (a timed-out worker may still write to it)."""
        # it stays in `_all`, so close() still unlinks it

    def summary(self) -> dict:
        with self._lock:
            return {"n_slabs": len(self._all),
                    "n_free": len(self._free),
                    "bytes": sum(s.capacity for s in self._all)}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            slabs, self._all, self._free = self._all, [], []
        for slab in slabs:
            try:
                slab.shm.close()
                slab.shm.unlink()
            except Exception:
                pass


@dataclass
class _Pending:
    event: threading.Event
    wid: int
    slot: dict = field(default_factory=dict)


class _Proc:
    def __init__(self, wid: int, n_procs: int):
        self.wid = wid
        self.task_q = _CTX.Queue()
        # single writer per pipe: this worker's death can only tear its
        # own reply channel, never another worker's
        self.result_r, result_w = _CTX.Pipe(duplex=False)
        self.process = _CTX.Process(
            target=_worker_main, args=(wid, n_procs, self.task_q, result_w),
            daemon=True)
        self.outstanding = 0
        self.failed = False     # reply pipe tore; reap even if still alive
        self.process.start()
        result_w.close()        # child holds the only writer: EOF = death

    def destroy(self) -> None:
        try:
            if self.process.is_alive():
                self.process.terminate()
        except Exception:
            pass
        try:
            self.result_r.close()
        except Exception:
            pass


class WorkerHost:
    """N spawned dispatch workers for one device + the slab ring feeding them.

    Thread-safe: the fleet's per-device executor threads call `eval`
    concurrently; one collector thread multiplexes the per-worker result
    pipes, completes pending calls, and respawns dead workers.  `device`
    is resolved as every entry point resolves it (None: the current CUDA
    device, raising without one); the workers run their programs there.
    """

    def __init__(self, device, n_procs: int, *,
                 slab_bytes: int = DEFAULT_SLAB_BYTES,
                 start_timeout_s: float = 60.0,
                 load_timeout_s: float = 60.0,
                 eval_timeout_s: float = 180.0):
        if n_procs < 1:
            raise ValueError("worker host needs at least one process")
        self.device = str(resolve_device(device))
        self.n_procs = n_procs
        self.eval_timeout_s = eval_timeout_s
        self.load_timeout_s = load_timeout_s
        self._start_timeout_s = start_timeout_s
        self._ring = SlabRing(slab_bytes)
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: dict[int, _Pending] = {}
        self._tenants: dict[str, bytes] = {}    # key -> pickled load payload
        self._procs: list[_Proc] = []
        self._closing = False
        self.n_evals = 0
        self.n_errors = 0
        self.n_respawns = 0
        self._collector: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.device.startswith("cuda"):
            from repro_torch.kernels import _build
            from repro_torch.kernels import cuda_circuit_sim as CK
            _build.build([CK.SOURCE])   # before any child can race to nvcc
        self._procs = [_Proc(i, self.n_procs)
                       for i in range(self.n_procs)]
        self._collector = threading.Thread(
            target=self._collect, name=f"workers-{self.device}", daemon=True)
        self._collector.start()
        deadline = time.monotonic() + self._start_timeout_s
        for p in self._procs:
            if not p.process.is_alive() and time.monotonic() > deadline:
                raise WorkerError(f"worker {p.wid} failed to start")

    def close(self) -> None:
        with self._lock:
            self._closing = True
            pending = list(self._pending.values())
            self._pending.clear()
        for ctx in pending:
            ctx.slot["err"] = "worker host closed"
            ctx.event.set()
        for p in self._procs:
            try:
                p.task_q.put(("stop",))
            except Exception:
                pass
        for p in self._procs:
            p.process.join(timeout=10.0)
            if p.process.is_alive():
                p.process.kill()
                p.process.join(timeout=5.0)
            p.task_q.close()
        if self._collector is not None:
            self._collector.join(timeout=5.0)
        for p in self._procs:
            try:
                p.result_r.close()
            except Exception:
                pass
        self._ring.close()

    # -- control plane -----------------------------------------------------

    def _payload(self, program, max_batch: int) -> bytes:
        return pickle.dumps({
            "ir": program.ir, "thresholds": program.thresholds,
            "n_classes": program.n_classes, "device": self.device,
            "max_batch": int(max_batch)})

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _broadcast(self, make_op, timeout_s: float, what: str) -> list:
        """Send one op per proc, wait for every ack, return payloads."""
        waits = []
        with self._lock:
            if self._closing:
                raise WorkerError("worker host closed")
            for p in self._procs:
                seq = self._next_seq()
                ctx = _Pending(threading.Event(), p.wid)
                self._pending[seq] = ctx
                p.outstanding += 1
                waits.append((p, seq, ctx))
        for p, seq, ctx in waits:
            p.task_q.put(make_op(seq))
        out = []
        for p, seq, ctx in waits:
            if not ctx.event.wait(timeout_s):
                with self._lock:
                    self._pending.pop(seq, None)
                raise WorkerError(f"{what} timed out on worker {p.wid} "
                                  f"({self.device})")
            if "err" in ctx.slot:
                raise WorkerError(f"{what} failed on worker {p.wid}: "
                                  f"{ctx.slot['err']}")
            out.append(ctx.slot.get("ok"))
        return out

    def load(self, key: str, program, max_batch: int) -> None:
        """Broadcast a tenant's program to every worker (waits for acks)."""
        blob = self._payload(program, max_batch)
        self._tenants[key] = blob
        self._broadcast(lambda seq: ("load", seq, key, blob),
                        self.load_timeout_s, f"load {key!r}")

    def unload(self, key: str) -> None:
        self._tenants.pop(key, None)
        with self._lock:
            if self._closing:
                return
            procs = list(self._procs)
        for p in procs:
            try:
                p.task_q.put(("unload", key))
            except Exception:
                pass

    def warmup(self, key: str, timeout_s: float = 300.0) -> float:
        """Warm every worker's engine for `key`; slowest warm dispatch wins."""
        dts = self._broadcast(lambda seq: ("warmup", seq, key),
                              timeout_s, f"warmup {key!r}")
        return max(float(d) for d in dts)

    def launches(self, timeout_s: float = 60.0) -> list[dict]:
        """Each worker's gate-walk launch counters (`cuda_circuit_sim`'s
        `LAUNCHES` and `VARIANT_LAUNCHES`), counted in its own process."""
        return self._broadcast(lambda seq: ("launches", seq), timeout_s,
                               "launches")

    # -- data plane --------------------------------------------------------

    def eval(self, key: str, x: np.ndarray) -> np.ndarray:
        """Classify one gathered (B, F) plane on the least-busy worker."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        B, F = x.shape
        need = B * F * 8 + B * 4
        slab = self._ring.acquire(need)
        timed_out = False
        try:
            np.ndarray((B, F), dtype=np.float64,
                       buffer=slab.shm.buf)[:] = x
            with self._lock:
                if self._closing:
                    raise WorkerError("worker host closed")
                proc = min(self._procs, key=lambda p: (p.outstanding, p.wid))
                seq = self._next_seq()
                ctx = _Pending(threading.Event(), proc.wid)
                self._pending[seq] = ctx
                proc.outstanding += 1
                self.n_evals += 1
            proc.task_q.put(("eval", seq, key, slab.name, B, F))
            if not ctx.event.wait(self.eval_timeout_s):
                timed_out = True
                with self._lock:
                    self._pending.pop(seq, None)
                    self.n_errors += 1
                raise WorkerError(
                    f"eval timed out after {self.eval_timeout_s:.0f}s on "
                    f"worker {proc.wid} ({self.device})")
            if "err" in ctx.slot:
                with self._lock:
                    self.n_errors += 1
                raise WorkerError(ctx.slot["err"])
            return np.array(np.ndarray((B,), dtype=np.int32,
                                       buffer=slab.shm.buf, offset=B * F * 8))
        finally:
            if timed_out:
                self._ring.quarantine(slab)
            else:
                self._ring.release(slab)

    # -- collector ---------------------------------------------------------

    def _collect(self) -> None:
        while True:
            with self._lock:
                if self._closing and not self._pending:
                    return
                conns = {p.result_r: p for p in self._procs if not p.failed}
            try:
                ready = _wait_ready(list(conns), timeout=0.25)
            except OSError:
                ready = []
            if not ready:
                if self._closing:
                    continue            # re-check pending under the lock
                self._check_procs()
                continue
            for c in ready:
                p = conns[c]
                try:
                    kind, wid, seq, payload = c.recv()
                except Exception:       # noqa: BLE001 — EOF or torn frame
                    p.failed = True     # reap + respawn on the next pass
                    continue
                if kind == "hello" or seq is None:
                    continue
                with self._lock:
                    ctx = self._pending.pop(seq, None)
                    if p.outstanding > 0:
                        p.outstanding -= 1
                if ctx is None:
                    continue            # timed out / host closing
                if kind == "err":
                    ctx.slot["err"] = payload
                else:
                    ctx.slot["ok"] = payload
                ctx.event.set()

    def _check_procs(self) -> None:
        """Fail pendings of dead workers and respawn them, tenants intact."""
        with self._lock:
            if self._closing:
                return
            dead = [i for i, p in enumerate(self._procs)
                    if p.failed or not p.process.is_alive()]
            if not dead:
                return
            orphans: list[_Pending] = []
            for i in dead:
                wid = self._procs[i].wid
                self._procs[i].destroy()
                mine = [self._pending.pop(s)
                        for s, c in list(self._pending.items())
                        if c.wid == wid]
                orphans.extend(mine)
                self.n_respawns += 1
                self.n_errors += len(mine)
                self._procs[i] = _Proc(wid, self.n_procs)
                for key, blob in self._tenants.items():
                    seq = self._next_seq()
                    # nobody waits on the reload ack; bookkeeping only
                    self._pending[seq] = _Pending(threading.Event(), wid)
                    self._procs[i].outstanding += 1
                    self._procs[i].task_q.put(("load", seq, key, blob))
        for ctx in orphans:
            ctx.slot["err"] = f"worker {ctx.wid} ({self.device}) died " \
                              f"mid-dispatch"
            ctx.event.set()

    def summary(self) -> dict:
        with self._lock:
            procs = [{"wid": p.wid, "pid": p.process.pid,
                      "alive": p.process.is_alive(),
                      "outstanding": p.outstanding} for p in self._procs]
        return {"device": self.device, "n_procs": self.n_procs,
                "n_evals": self.n_evals, "n_errors": self.n_errors,
                "n_respawns": self.n_respawns,
                "tenants": sorted(self._tenants),
                "slabs": self._ring.summary(), "procs": procs}
