"""Multi-tenant sensor-serving fleet: router, replica pools, admission.

The port of `repro.serve.fleet`.  The reference keys everything by a
backend name; here the device decides: a tenant names a device (`None`:
the current CUDA device, raising without one), its replicas' programs run
there (the CUDA kernels on a card, their plain PyTorch versions on the
CPU), and nothing falls back from one to the other.

One `ClassifierFleet` serves every classifier emitted under an emit
directory (`python -m repro_torch.compile.export` and the reference's
emitters write the same bundles and `fleet.json`): each manifest tenant
gets a **replica pool** of `CircuitServingEngine`s over the loaded program
(`serve/replicas.py` — least-loaded pick, replicas pinned through
`kernels.dispatch.replica_devices` to the tenant's device), and a single
router fans `submit(tenant, reading)` calls into per-tenant
`MicroBatcher` queues.

Dispatch is pushed off the caller thread: one background scheduler thread
per *device* watches the queues of the tenants pinned to it and hands a
due batch — `max_batch` queued, or the oldest request about to outlive
its latency budget (see `batcher.py`) — to the least-loaded idle replica
on a per-device dispatch executor, so a hot tenant's batches overlap
across replicas instead of queueing behind each other.  Replicas on one
card launch on their dispatch threads' current stream.  Per-batch
execution cost is tracked as an EMA per tenant and fed back into the
deadline policy, so "about to" means "could not survive one more dispatch
interval".

**Admission control**: a tenant with `max_queue` set sheds new
submissions once its queue is that deep — `submit` raises
`FleetOverloadError` carrying a `retry_after_ms` hint sized from the
backlog and the tenant's dispatch-cost estimate — so overload shows up as
explicit sheds (counted in `ServeStats.n_shed`) instead of silent SLO
misses on accepted traffic.

**QoS + rate limits**: tenants carry a QoS class — `guaranteed` sheds
only on hard queue limits and is scheduled first among due tenants;
`best_effort` additionally sheds whenever its device's total backlog
crosses the fleet's `best_effort_backlog` threshold, so under overload
the best-effort tenants give way *before* guaranteed tenants start
missing SLOs.  A per-tenant token bucket (`rate_limit_rps` +
`rate_burst`) gates admission the same way, with `retry_after_ms` hints
sized from the bucket's actual refill deficit.

**Autoscaling**: pass an `AutoscaleConfig` and each tenant's replica
pool is resized from its live signals — sustained sheds, queue-depth
pressure, dispatch-cost EMA — under round-based hysteresis with
`min_replicas`/`max_replicas` bounds from the spec (`serve/autoscale.py`
is the pure decision law; `autoscale_tick()` applies it and is safe to
drive from a test with a fake clock).  Shadow tenants are never scaled.

**Megakernel**: with `megakernel=True` every due tenant of one device
rides ONE launch per scheduler pass: each tenant's batch is binarized and
packed by its engine (`prepare_packed_batch`), and the padded plans and
their schedule come from `cuda_circuit_sim.fleet_plan`'s content-keyed
cache after the first dispatch of a set of tenants
(`kernels.dispatch.fleet_eval_words`).

**Worker processes**: with `workers=N`, dispatch leaves this process —
each device gets N spawned subprocesses holding their own engines, fed
through a ring of shared-memory reading planes (`serve/workers.py`).
Scheduling, admission, stats and completion all stay here; only
`classify_batch` crosses the process boundary.

**Hot reload**: a fleet built by `from_emit_dir` can `sync_manifest()` at
any time — new manifest rows become tenants, rows whose generation
counter moved are replaced (queued requests transfer to the successor
with their deadline clocks intact; in-flight batches finish on the old
engines), and vanished rows retire after their backlog is served.  The
socket server (`serve/server.py`) drives this from an mtime watcher.

Everything the scheduler adds is bookkeeping — labels come from the same
`CircuitProgram` the offline path runs, so fleet output is bit-identical
to `CircuitProgram.predict` per tenant on every device.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.compile.artifact import load_manifest_doc, load_program
from repro_torch.compile.program import CircuitProgram
from repro_torch.device import resolve_device
from repro_torch.serve.autoscale import (QOS_CLASSES, Autoscaler,
                                         AutoscaleConfig, TenantSignals,
                                         TokenBucket)
from repro_torch.serve.batcher import MicroBatcher, QueuedItem
from repro_torch.serve.engine import (STATS_WINDOW, CircuitServingEngine,
                                      ServeStats)
from repro_torch.serve.replicas import (EngineReplica, ReplicaPool,
                                        make_replica)
from repro_torch.serve.shadow import ShadowComparator
from repro_torch.serve.workers import WorkerHost

DEFAULT_DEADLINE_MS = 50.0
DEFAULT_MAX_BATCH = 256


class FleetOverloadError(RuntimeError):
    """Submission shed by admission control; retry after `retry_after_ms`.

    `reason` names which gate shed it: ``"queue"`` (the tenant's
    `max_queue` depth limit), ``"rate"`` (its token bucket ran dry), or
    ``"qos"`` (a best-effort tenant gave way to device-wide backlog).
    """

    def __init__(self, tenant: str, queue_depth: int, max_queue: int | None,
                 retry_after_ms: float, reason: str = "queue"):
        super().__init__(
            f"tenant {tenant!r} shed ({reason}: {queue_depth} queued"
            + (f", limit {max_queue}" if max_queue is not None else "")
            + f"); retry after {retry_after_ms:.1f} ms")
        self.tenant = tenant
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.retry_after_ms = retry_after_ms
        self.reason = reason


@dataclass
class FleetRequest:
    """One routed sensor reading; completion is signalled via `result()`."""

    uid: int
    tenant: str
    readings: np.ndarray
    deadline_ms: float
    label: int | None = None
    latency_ms: float | None = None
    error: str | None = None
    batch_uid: int | None = None    # frame identity (submit_many arrivals)
    _plane: np.ndarray | None = field(default=None, repr=False)
    _row: int = 0                   # this request's row in `_plane`
    _t_submit: float = 0.0
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)
    _callbacks: list = field(default_factory=list, repr=False)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock,
                                     repr=False)

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Run `fn(self)` when the request completes (immediately if it
        already has) — the hook the socket server uses to stream results
        back without parking a thread per request."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _complete(self) -> None:
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)

    def result(self, timeout: float | None = None) -> int:
        """Block until the label is ready (raises on timeout/cancel)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.uid} ({self.tenant}) not "
                               f"served within {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.uid} ({self.tenant}) failed: "
                               f"{self.error}")
        return self.label

    @property
    def slo_miss(self) -> bool:
        return self.latency_ms is not None and self.latency_ms > self.deadline_ms


@dataclass
class TenantSpec:
    """Everything needed to stand up one tenant's replica pool."""

    name: str
    program: CircuitProgram
    device: str | torch.device | None = None   # None: the current CUDA
                                                # device
    max_batch: int = DEFAULT_MAX_BATCH
    deadline_ms: float = DEFAULT_DEADLINE_MS
    replicas: int = 1
    max_queue: int | None = None       # admission limit; None = never shed
    dataset: str | None = None
    generation: int = 0                # manifest generation that emitted it
    sha256: str | None = None          # bundle digest the manifest recorded
    qos: str = "guaranteed"            # guaranteed | best_effort
    rate_limit_rps: float | None = None  # token-bucket admission rate
    rate_burst: float | None = None    # bucket depth; default max(rate, batch)
    min_replicas: int | None = None    # autoscale floor; default 1
    max_replicas: int | None = None    # autoscale ceiling; default `replicas`
    meta: dict = field(default_factory=dict)


class _Tenant:
    """Runtime state: replica pool + queue + dispatch-cost estimate."""

    def __init__(self, spec: TenantSpec, stats_window: int):
        self.device = resolve_device(spec.device)
        if spec.replicas < 1:
            raise ValueError("a tenant needs at least one replica")
        if spec.max_queue is not None and spec.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if spec.qos not in QOS_CLASSES:
            raise ValueError(f"unknown qos class {spec.qos!r}; "
                             f"valid: {', '.join(QOS_CLASSES)}")
        if spec.min_replicas is not None and spec.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (or None)")
        if (spec.max_replicas is not None
                and spec.max_replicas < max(1, spec.min_replicas or 1)):
            raise ValueError("max_replicas must be >= min_replicas")
        self.spec = spec
        self.pool = ReplicaPool.from_program(spec.program, spec.replicas,
                                             spec.max_batch,
                                             stats_window=stats_window,
                                             devices=(self.device,))
        self.batcher = MicroBatcher(spec.max_batch, spec.deadline_ms)
        self.stats = ServeStats(window=stats_window)
        self.bucket: TokenBucket | None = None
        if spec.rate_limit_rps is not None:
            burst = (spec.rate_burst if spec.rate_burst is not None
                     else max(spec.rate_limit_rps, spec.max_batch))
            self.bucket = TokenBucket(spec.rate_limit_rps, burst)
        self.est_dispatch_s = 1e-3      # EMA of recent dispatch cost
        self.last_dispatch_s = 1e-3     # most recent (spike-sensitive)
        self.retiring = False           # drain, then drop from the worker
        self.from_manifest = False      # sync_manifest may retire it
        self.shadow_of: str | None = None      # incumbent it mirrors, if any
        self.comparator: ShadowComparator | None = None
        self.worker_key: str | None = None     # set when dispatch is
                                               # delegated to a WorkerHost
        self._as_last_shed = 0          # autoscale_tick round deltas
        self._as_last_requests = 0

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def device_key(self) -> str:
        """The scheduler / worker-host key: the resolved device's name."""
        return str(self.device)

    @property
    def engine(self) -> CircuitServingEngine:
        """Replica 0 — the bulk/offline-reference engine."""
        return self.pool.replicas[0].engine


class _DeviceWorker(threading.Thread):
    """One scheduler thread per device.

    Owns the queues of every tenant pinned to its device behind one
    condition variable: producers notify on submit, the loop sleeps until
    the earliest possible due instant, pops the most urgent due batch
    *that has an idle replica*, and hands it to the dispatch executor so
    the scheduler never blocks on device time — that is what lets two due
    batches of one hot tenant overlap on different replicas.
    """

    def __init__(self, fleet: "ClassifierFleet", device: str,
                 tenants: list[_Tenant]):
        super().__init__(name=f"fleet-dispatch-{device}", daemon=True)
        self.fleet = fleet
        self.device = device
        self.tenants = tenants
        # megakernel mode: every due tenant of this device rides ONE
        # multi-program kernel launch per scheduler pass instead of
        # per-tenant dispatches
        self.fused = bool(fleet.megakernel)
        self.cond = threading.Condition()
        self.stop = False          # set under cond; drain-all then exit
        self.kick = False          # flush(): treat every queue as due
        self.in_flight = 0
        self._exec: ThreadPoolExecutor | None = None
        self._exec_workers = 0

    def _ensure_executor(self) -> ThreadPoolExecutor:
        want = max(2, sum(t.pool.size for t in self.tenants))
        if self._exec is None or want > self._exec_workers:
            old = self._exec
            self._exec = ThreadPoolExecutor(
                max_workers=want,
                thread_name_prefix=f"fleet-exec-{self.device}")
            self._exec_workers = want
            if old is not None:     # running dispatches finish on old threads
                old.shutdown(wait=False)
        return self._exec

    # policy: urgency-ordered among due tenants --------------------------
    def _eta_s(self, t: _Tenant) -> float:
        """Expected submit-of-flush -> completion cost for one batch.

        Taking the max of the smoothed and the most recent dispatch time
        keeps the deadline trigger honest when a device's cost spikes
        (e.g. a first launch or a host stall): an EMA alone lags the spike and
        converts near-deadline flushes into systematic small overshoots.
        """
        return (max(t.est_dispatch_s, t.last_dispatch_s)
                * self.fleet.safety_factor + self.fleet.sched_slack_s)

    def _due(self, t: _Tenant, now: float) -> bool:
        return bool(len(t.batcher)) and (
            self.stop or self.kick or t.retiring
            or t.batcher.due(now, self._eta_s(t)))

    @staticmethod
    def _qos_rank(t: _Tenant) -> int:
        """Scheduling priority among due tenants: guaranteed first, then
        best-effort, then shadows (mirrored traffic never delays either)."""
        if t.shadow_of is not None:
            return 2
        return 0 if t.spec.qos == "guaranteed" else 1

    def _pick(self, now: float) -> _Tenant | None:
        due = [t for t in self.tenants
               if self._due(t, now) and t.pool.has_idle()]
        if not due:
            return None
        return min(due, key=lambda t: (self._qos_rank(t),
                                       t.batcher.oldest_due_at))

    def _wait_s(self, now: float) -> float | None:
        # tenants whose pool is saturated wake via the release notify, not
        # a timer — including them here would spin the scheduler
        wakes = [t.batcher.next_due_at(self._eta_s(t))
                 for t in self.tenants if len(t.batcher)
                 and t.pool.has_idle()]
        if not wakes:
            return None                      # sleep until notified
        return max(1e-4, min(wakes) - now)

    def queued(self) -> int:
        return sum(len(t.batcher) for t in self.tenants)

    def _reap_retired(self) -> None:
        """Drop fully drained retiring tenants (caller holds `cond`)."""
        drained = [t for t in self.tenants
                   if t.retiring and not len(t.batcher) and t.pool.idle()]
        if drained:
            self.tenants = [t for t in self.tenants if t not in drained]
            for t in drained:       # free the worker procs' engines too
                self.fleet._unload_worker_tenant(t)
            self.cond.notify_all()

    def _pick_jobs(self, now: float) -> list[_Tenant]:
        """Megakernel mode: EVERY due tenant with an idle replica, ordered
        guaranteed -> best-effort -> shadow (they all share one launch, so
        the order only fixes result/stat attribution, not service)."""
        due = [t for t in self.tenants
               if self._due(t, now) and t.pool.has_idle()]
        return sorted(due, key=lambda t: (self._qos_rank(t),
                                          t.batcher.oldest_due_at))

    def run(self) -> None:
        while True:
            with self.cond:
                while True:
                    self._reap_retired()
                    now = self.fleet._clock()
                    picked = (self._pick_jobs(now) if self.fused
                              else [t for t in (self._pick(now),)
                                    if t is not None])
                    if picked:
                        jobs = []
                        for tenant in picked:
                            batch = tenant.batcher.pop_batch()
                            replica = tenant.pool.acquire(len(batch))
                            self.in_flight += len(batch)
                            jobs.append((tenant, replica, batch))
                        break
                    if (self.stop and self.queued() == 0
                            and self.in_flight == 0):
                        if self._exec is not None:
                            self._exec.shutdown(wait=False)
                        return
                    self.cond.wait(self._wait_s(now))
                ex = self._ensure_executor()
            if self.fused:
                ex.submit(self._run_dispatch_fused, jobs)
            else:
                ex.submit(self._run_dispatch, *jobs[0])

    def _run_dispatch(self, tenant: _Tenant, replica: EngineReplica,
                      batch: list[QueuedItem]) -> None:
        ok = False
        try:
            ok = self.fleet._dispatch(tenant, replica, batch)
        finally:
            with self.cond:
                # a failed dispatch served nothing: credit the acquire-time
                # readings charge back so routing doesn't treat the error
                # as load this replica carried
                tenant.pool.release(replica, n_readings=len(batch), ok=ok)
                self.in_flight -= len(batch)
                self._reap_retired()
                self.cond.notify_all()

    def _run_dispatch_fused(self, jobs: list) -> None:
        ok = False
        try:
            ok = self.fleet._dispatch_fused(jobs)
        finally:
            with self.cond:
                for tenant, replica, batch in jobs:
                    tenant.pool.release(replica, n_readings=len(batch),
                                        ok=ok)
                    self.in_flight -= len(batch)
                self._reap_retired()
                self.cond.notify_all()


class ClassifierFleet:
    """Router + scheduler over per-tenant replica pools."""

    def __init__(self, specs: list[TenantSpec], *,
                 stats_window: int = STATS_WINDOW,
                 safety_factor: float = 1.5, sched_slack_s: float = 5e-3,
                 warmup: bool = True, autostart: bool = True,
                 workers: int | None = None,
                 best_effort_backlog: int | None = None,
                 autoscale: AutoscaleConfig | None = None,
                 autoscale_interval_s: float = 1.0,
                 megakernel: bool = False,
                 clock=time.perf_counter):
        if not specs:
            raise ValueError("a fleet needs at least one tenant")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        if workers is not None and workers < 1:
            raise ValueError("workers must be >= 1 (or None for in-process)")
        if megakernel and workers is not None:
            raise ValueError("megakernel dispatch is in-process (the fused "
                             "launch pools every tenant's plan in one "
                             "kernel) — it cannot ride worker subprocesses")
        self.stats = ServeStats(window=stats_window)
        self.stats_window = stats_window
        self.safety_factor = safety_factor
        self.sched_slack_s = sched_slack_s
        self.warmup_on_load = warmup
        self.best_effort_backlog = best_effort_backlog
        self._clock = clock
        self.workers = workers
        self.megakernel = bool(megakernel)
        self._megakernel_launches = 0       # fused multi-tenant launches
        self._megakernel_peak_tenants = 0   # most tenants in one launch
        self._worker_hosts: dict[str, WorkerHost] = {}  # device -> host
        self._worker_key_seq = 0
        self._autoscaler = Autoscaler(autoscale) if autoscale else None
        self._autoscale_interval_s = autoscale_interval_s
        self._autoscale_stop = threading.Event()
        self._autoscale_thread: threading.Thread | None = None
        self._scale_events: list[dict] = []
        self._tenants: dict[str, _Tenant] = {
            s.name: self._build_tenant(s) for s in specs}
        by_device: dict[str, list[_Tenant]] = {}
        for t in self._tenants.values():
            by_device.setdefault(t.device_key, []).append(t)
        self._workers = {d: _DeviceWorker(self, d, ts)
                         for d, ts in sorted(by_device.items())}
        self._uid_lock = threading.Lock()
        self._next_uid = 0
        self._next_batch_uid = 0        # one per submit_many frame
        self._shadows: dict[str, _Tenant] = {}   # incumbent name -> shadow
        self._manifest_generation = 0
        self.errors: list[str] = []     # dispatch-thread failures, in order
        self._shutdown = False
        self._started = False
        self._admin_lock = threading.Lock()   # add/replace/retire
        self._sync_lock = threading.Lock()    # one manifest reconcile at a
                                              # time (watcher + RELOAD RPC)
        self._manifest_ctx: dict | None = None   # set by from_emit_dir
        if autostart:
            self.start()

    def _ensure_host(self, device: str) -> WorkerHost:
        host = self._worker_hosts.get(device)
        if host is None:
            host = WorkerHost(device, self.workers)
            host.start()
            self._worker_hosts[device] = host
        return host

    def _unload_worker_tenant(self, t: _Tenant) -> None:
        """Drop a reaped tenant's engines from its worker procs, if any."""
        if t.worker_key is None:
            return
        host = self._worker_hosts.get(t.device_key)
        if host is not None:
            host.unload(t.worker_key)

    def _build_tenant(self, spec: TenantSpec) -> _Tenant:
        t = _Tenant(spec, self.stats_window)
        if self.workers is not None:
            # dispatch runs out-of-process: broadcast the program to the
            # device's worker procs (each holds its own engine on that
            # device) under a generation-unique key, so a replaced tenant's
            # in-flight batches still hit the *old* program until reaped
            host = self._ensure_host(t.device_key)
            self._worker_key_seq += 1
            t.worker_key = f"{spec.name}#{self._worker_key_seq}"
            host.load(t.worker_key, spec.program, spec.max_batch)
            if self.warmup_on_load:
                est = max(1e-4, host.warmup(t.worker_key))
                t.est_dispatch_s = est
                t.last_dispatch_s = est
        elif self.warmup_on_load:
            # every replica: each holds its own program and schedule, and a
            # cold replica would pay its first launch (the kernel library's
            # load on a card) inside its first deadline-bound batch
            est = 1e-4
            for rep in t.pool.replicas:
                est = max(est, rep.engine.warmup())
            t.est_dispatch_s = est
            t.last_dispatch_s = est
        return t

    # -- construction -------------------------------------------------------
    @classmethod
    def from_emit_dir(cls, emit_dir: str | Path,
                      device=None,
                      max_batch: int = DEFAULT_MAX_BATCH,
                      deadline_ms: float = DEFAULT_DEADLINE_MS,
                      tenants: list[str] | None = None,
                      replicas: int | dict[str, int] | None = None,
                      max_queue: int | None = None,
                      qos: str | dict[str, str] | None = None,
                      rate_limit_rps: float | dict[str, float] | None = None,
                      min_replicas: int | None = None,
                      max_replicas: int | None = None,
                      **kw) -> "ClassifierFleet":
        """Serve every artifact the emit dir's `fleet.json` manifest names.

        `device` pins execution: one device for the whole fleet, or a
        `{tenant: device}` map; None (and a name the map lacks) means the
        current CUDA device, which raises without one.
        `replicas` overrides the manifest's per-tenant replica hints the
        same way; `max_queue` arms admission control for every tenant.
        `qos` / `rate_limit_rps` follow the same scalar-or-map shape
        (missing names fall back to `guaranteed` / unlimited), and
        `min_replicas`/`max_replicas` bound the autoscaler for every
        tenant.  The resulting fleet remembers the directory, so
        `sync_manifest()` hot-reloads added/replaced/retired manifest
        rows later.
        """
        emit_dir = Path(emit_dir)
        ctx = {"emit_dir": emit_dir, "device": device,
               "max_batch": max_batch, "deadline_ms": deadline_ms,
               "tenants": tenants, "replicas": replicas,
               "max_queue": max_queue, "qos": qos,
               "rate_limit_rps": rate_limit_rps,
               "min_replicas": min_replicas, "max_replicas": max_replicas}
        doc = load_manifest_doc(emit_dir)
        rows = doc["tenants"]
        if tenants is not None:
            known = {r["name"] for r in rows}
            missing = sorted(set(tenants) - known)
            if missing:
                raise KeyError(f"tenants not in manifest: "
                               f"{', '.join(missing)}; available: "
                               f"{', '.join(sorted(known))}")
            rows = [r for r in rows if r["name"] in tenants]
        specs = [cls._spec_from_row(row, ctx) for row in rows]
        fleet = cls(specs, **kw)
        fleet._manifest_ctx = ctx
        fleet._manifest_generation = doc.get("generation", 0)
        for t in fleet._tenants.values():
            t.from_manifest = True
        return fleet

    @staticmethod
    def _spec_from_row(row: dict, ctx: dict) -> TenantSpec:
        devices = ctx["device"]
        device = (devices.get(row["name"]) if isinstance(devices, dict)
                  else devices)
        replicas = ctx["replicas"]
        n_replicas = (replicas if isinstance(replicas, int)
                      else (replicas or {}).get(row["name"],
                                                int(row.get("replicas", 1))))
        # cross-check the bundle against the digest the row recorded: a
        # sidecar that agrees with its bundle can still disagree with the
        # manifest that promised it (stale emit, swapped file, tampered row)
        program = load_program(ctx["emit_dir"] / row["program"],
                               device=device,
                               expect_sha256=row.get("sha256"))
        qos_ctx = ctx.get("qos")
        qos = (qos_ctx if isinstance(qos_ctx, str)
               else (qos_ctx or {}).get(row["name"],
                                        row.get("qos", "guaranteed")))
        rate_ctx = ctx.get("rate_limit_rps")
        rate = (rate_ctx if isinstance(rate_ctx, (int, float))
                else (rate_ctx or {}).get(row["name"]))
        return TenantSpec(
            name=row["name"], program=program, device=device,
            max_batch=ctx["max_batch"], deadline_ms=ctx["deadline_ms"],
            replicas=max(1, n_replicas), max_queue=ctx["max_queue"],
            dataset=row.get("dataset"),
            generation=int(row.get("generation", 0)),
            sha256=row.get("sha256"), qos=qos, rate_limit_rps=rate,
            min_replicas=ctx.get("min_replicas"),
            max_replicas=ctx.get("max_replicas"), meta=dict(row))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if not self._started:
            self._started = True
            for w in self._workers.values():
                w.start()
            if self._autoscaler is not None and self._autoscale_interval_s > 0:
                self._autoscale_thread = threading.Thread(
                    target=self._autoscale_loop, name="fleet-autoscale",
                    daemon=True)
                self._autoscale_thread.start()

    def _autoscale_loop(self) -> None:
        while not self._autoscale_stop.wait(self._autoscale_interval_s):
            try:
                self.autoscale_tick()
            except Exception as exc:    # noqa: BLE001 — keep the loop alive
                self.errors.append(f"autoscale: {type(exc).__name__}: {exc}")

    def __enter__(self) -> "ClassifierFleet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    @property
    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    def tenant_device(self, name: str) -> str:
        return self._tenant(name).device_key

    def tenant_replicas(self, name: str) -> int:
        return self._tenant(name).pool.size

    def n_features(self, name: str) -> int:
        return self._tenant(name).engine.n_features

    def _tenant(self, name: str) -> _Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; serving: "
                           f"{', '.join(self.tenants)}") from None

    @property
    def pending(self) -> int:
        return sum(w.queued() + w.in_flight for w in self._workers.values())

    # -- request path --------------------------------------------------------
    def _retry_after_ms(self, t: _Tenant, depth: int) -> float:
        """How long until the backlog plausibly fits under `max_queue`:
        batches ahead of a new arrival, spread over the replica pool, at
        the tenant's current dispatch-cost estimate."""
        batches_ahead = math.ceil(max(1, depth) / t.spec.max_batch)
        est = max(t.est_dispatch_s, t.last_dispatch_s, 1e-4)
        return max(1.0, batches_ahead * est * 1e3 / t.pool.size)

    def _qos_shed(self, t: _Tenant, worker: _DeviceWorker) -> bool:
        """Should a best-effort submission give way right now?

        True when the tenant is `best_effort`, the fleet has a
        `best_effort_backlog` threshold, and the tenant's *device* —
        queued plus in-flight across every tenant pinned to it — is
        already past that threshold.  Caller holds `worker.cond`.
        """
        return (t.spec.qos == "best_effort"
                and self.best_effort_backlog is not None
                and worker.queued() + worker.in_flight
                >= self.best_effort_backlog)

    def submit(self, tenant: str, readings: np.ndarray,
               deadline_ms: float | None = None) -> FleetRequest:
        """Queue one reading for `tenant`; returns a completion handle.

        Raises `FleetOverloadError` (with a `retry_after_ms` hint) instead
        of queueing when an admission gate trips — the tenant's
        `max_queue` depth limit, a best-effort tenant's device backlog
        threshold, or the tenant's token bucket — so accepted requests
        keep meeting their deadlines and overload becomes visible as
        sheds rather than SLO misses.
        """
        readings = np.asarray(readings, dtype=np.float64).reshape(-1)
        while True:
            t = self._tenant(tenant)
            if readings.shape[0] != t.engine.n_features:
                raise ValueError(f"{tenant}: expected {t.engine.n_features} "
                                 f"features, got {readings.shape[0]}")
            worker = self._worker_of(t)
            with worker.cond:
                if self._shutdown:
                    raise RuntimeError("fleet is shut down")
                if self._tenants.get(tenant) is not t:
                    continue        # replaced mid-flight; retry on successor
                depth = len(t.batcher)
                if t.spec.max_queue is not None and depth >= t.spec.max_queue:
                    retry_ms = self._retry_after_ms(t, depth)
                    t.stats.record_shed()
                    self.stats.record_shed()
                    raise FleetOverloadError(tenant, depth, t.spec.max_queue,
                                             retry_ms)
                if self._qos_shed(t, worker):
                    retry_ms = self._retry_after_ms(t, depth)
                    t.stats.record_shed()
                    self.stats.record_shed()
                    raise FleetOverloadError(tenant, depth, t.spec.max_queue,
                                             retry_ms, reason="qos")
                if t.bucket is not None:
                    now = self._clock()
                    if t.bucket.take_upto(1, now) < 1:
                        retry_ms = max(1.0,
                                       t.bucket.retry_after_s(1, now) * 1e3)
                        t.stats.record_shed()
                        self.stats.record_shed()
                        raise FleetOverloadError(tenant, depth,
                                                 t.spec.max_queue, retry_ms,
                                                 reason="rate")
                with self._uid_lock:
                    uid = self._next_uid
                    self._next_uid += 1
                req = FleetRequest(
                    uid=uid, tenant=tenant, readings=readings,
                    deadline_ms=(t.spec.deadline_ms if deadline_ms is None
                                 else deadline_ms))
                entry = t.batcher.submit(req, now=self._clock(),
                                         deadline_ms=req.deadline_ms)
                req._t_submit = entry.t_submit
                worker.cond.notify_all()
            # mirror *after* the incumbent's scheduler lock is released:
            # shadow traffic must never serialize against — or error into —
            # the serving path that admitted the request
            self._mirror(tenant, [req])
            return req

    def submit_many(self, tenant: str, readings: np.ndarray,
                    deadlines_ms=None
                    ) -> tuple[list[FleetRequest], np.ndarray, float]:
        """Queue a whole `(B, F)` frame under one scheduler-lock acquisition.

        The batched-ingest fast path: uids are allocated in one block, the
        frame enters the tenant's queue as one contiguous arrival-order
        run (`MicroBatcher.submit_many`), and every request keeps a view
        into the shared reading plane so dispatch can slice it instead of
        re-stacking rows (`batch_uid` threads the frame identity through
        to `ReplicaPool` accounting).

        Admission is per-row: with `max_queue` armed, the head of the
        frame is admitted up to the remaining queue room — further capped
        by the tenant's token-bucket grant when rate limits are armed,
        and zeroed entirely for a best-effort tenant whose device is
        past the fleet's backlog threshold — and the tail is shed.
        Returns ``(requests, shed_idx, retry_after_ms)`` — admitted
        requests in row order, the row indices that were shed, and the
        backoff hint for them (0.0 when nothing shed).  `deadlines_ms` is
        None, a scalar, or one value per row; NaN rows use the tenant's
        default budget.

        A malformed deadline table (any non-positive finite row) rejects
        the *whole* frame with ValueError before any row is admitted,
        shed-counted, or assigned a uid — admission is all-or-nothing per
        row, never torn mid-frame.
        """
        x = np.ascontiguousarray(np.asarray(readings, dtype=np.float64))
        if x.ndim == 1:
            x = x.reshape(1, -1)
        if x.ndim != 2:
            raise ValueError(f"expected (B, F) readings, got {x.shape}")
        B = x.shape[0]
        if deadlines_ms is None:
            dls = None
        else:
            dls = np.broadcast_to(
                np.asarray(deadlines_ms, dtype=np.float64), (B,))
            bad = ~np.isnan(dls) & ~(dls > 0)    # catches <=0 and -inf
            if bad.any():
                rows = np.flatnonzero(bad)[:8].tolist()
                raise ValueError(
                    f"{tenant}: non-positive deadline_ms at rows {rows} — "
                    f"frame rejected whole (deadline budget must be "
                    f"positive)")
        while True:
            t = self._tenant(tenant)
            if x.shape[1] != t.engine.n_features:
                raise ValueError(f"{tenant}: expected {t.engine.n_features} "
                                 f"features, got {x.shape[1]}")
            worker = self._worker_of(t)
            with worker.cond:
                if self._shutdown:
                    raise RuntimeError("fleet is shut down")
                if self._tenants.get(tenant) is not t:
                    continue        # replaced mid-flight; retry on successor
                depth = len(t.batcher)
                if t.spec.max_queue is None:
                    n_admit = B
                else:
                    n_admit = max(0, min(B, t.spec.max_queue - depth))
                retry_hint = 0.0
                if n_admit and self._qos_shed(t, worker):
                    n_admit = 0     # best-effort gives way wholesale
                if n_admit and t.bucket is not None:
                    now = self._clock()
                    granted = t.bucket.take_upto(n_admit, now)
                    if granted < n_admit:
                        retry_hint = max(
                            1.0, t.bucket.retry_after_s(1, now) * 1e3)
                    n_admit = granted
                n_shed = B - n_admit
                if n_shed:
                    t.stats.record_shed(n_shed)
                    self.stats.record_shed(n_shed)
                if n_admit == 0:
                    return ([], np.arange(B),
                            max(retry_hint, self._retry_after_ms(t, depth)))
                with self._uid_lock:
                    uid0 = self._next_uid
                    self._next_uid += n_admit
                    batch_uid = self._next_batch_uid
                    self._next_batch_uid += 1
                default = t.spec.deadline_ms
                reqs = []
                for i in range(n_admit):
                    d = default if dls is None else float(dls[i])
                    if d != d:              # NaN -> tenant default
                        d = default
                    reqs.append(FleetRequest(
                        uid=uid0 + i, tenant=tenant, readings=x[i],
                        deadline_ms=d, batch_uid=batch_uid,
                        _plane=x, _row=i))
                entries = t.batcher.submit_many(
                    reqs, now=self._clock(),
                    deadlines_ms=[r.deadline_ms for r in reqs])
                for r, e in zip(reqs, entries):
                    r._t_submit = e.t_submit
                worker.cond.notify_all()
            self._mirror(tenant, reqs)   # admitted rows only; sheds are not
            shed_idx = np.arange(n_admit, B)     # real traffic to compare on
            retry_ms = (max(retry_hint, self._retry_after_ms(t, depth + n_admit))
                        if n_shed else 0.0)
            return reqs, shed_idx, retry_ms

    def _worker_of(self, t: _Tenant) -> _DeviceWorker:
        return self._workers[t.device_key]

    def _mirror(self, tenant: str, primaries: list[FleetRequest]) -> None:
        """Copy freshly admitted requests to `tenant`'s shadow, if any.

        Best-effort by design: a full shadow queue *drops* mirrors
        (counted in the comparator) rather than backpressuring the
        incumbent — mirrored traffic must cost the serving path nothing.
        Each mirror is paired with its primary by the primary's uid via
        completion callbacks into the `ShadowComparator`.
        """
        if not primaries:
            return
        sh = self._shadows.get(tenant)
        if sh is None:
            return
        comp = sh.comparator
        worker = self._worker_of(sh)
        with worker.cond:
            if (self._shutdown or sh.retiring
                    or self._shadows.get(tenant) is not sh):
                comp.record_dropped(len(primaries))
                return
            room = (len(primaries) if sh.spec.max_queue is None
                    else max(0, sh.spec.max_queue - len(sh.batcher)))
            admit, dropped = primaries[:room], primaries[room:]
            if dropped:
                comp.record_dropped(len(dropped))
            if not admit:
                return
            with self._uid_lock:
                uid0 = self._next_uid
                self._next_uid += len(admit)
            mirrors = []
            for i, p in enumerate(admit):
                m = FleetRequest(
                    uid=uid0 + i, tenant=sh.name, readings=p.readings,
                    deadline_ms=p.deadline_ms, batch_uid=p.batch_uid,
                    _plane=p._plane, _row=p._row)
                comp.expect(p.uid)
                m.add_done_callback(
                    lambda r, _uid=p.uid: comp.observe_shadow(_uid, r))
                mirrors.append(m)
            entries = sh.batcher.submit_many(
                mirrors, now=self._clock(),
                deadlines_ms=[m.deadline_ms for m in mirrors])
            for m, e in zip(mirrors, entries):
                m._t_submit = e.t_submit
            worker.cond.notify_all()
        # outside the shadow worker lock — a primary that already completed
        # runs the callback synchronously right here
        for p in admit:
            p.add_done_callback(comp.observe_primary)

    def classify_stream(self, tenant: str, x: np.ndarray) -> np.ndarray:
        """Bulk path: route a whole `(S, F)` stream straight to replica 0."""
        return self._tenant(tenant).engine.classify_stream(x)

    # -- dispatch (executor threads) -----------------------------------------
    @staticmethod
    def _gather_batch(reqs: list[FleetRequest]) -> np.ndarray:
        """Readings of a popped batch as one `(B, F)` array.

        When every request is a consecutive row of the same submit_many
        plane (the batched-ingest case), the batch is a zero-copy slice of
        that plane; anything else falls back to stacking per-request rows.
        """
        first = reqs[0]
        plane = first._plane
        if plane is not None and all(
                r._plane is plane and r._row == first._row + i
                for i, r in enumerate(reqs)):
            return plane[first._row: first._row + len(reqs)]
        return np.stack([r.readings for r in reqs])

    def _dispatch(self, tenant: _Tenant, replica: EngineReplica,
                  entries: list[QueuedItem]) -> bool:
        """Serve one popped batch; returns True iff it completed cleanly."""
        reqs: list[FleetRequest] = [e.item for e in entries]
        # a shadow's dispatches never touch fleet-level stats or the fleet
        # error log: mirrored traffic is an experiment riding alongside the
        # SLO-accounted serving path, and a broken candidate must show up
        # in its comparator, not in the fleet's health signals
        is_shadow = tenant.shadow_of is not None
        host = (self._worker_hosts.get(tenant.device_key)
                if tenant.worker_key is not None else None)
        try:
            x = self._gather_batch(reqs)
            # the dispatch timing deliberately includes the worker-path IPC
            # (slab copy + queue round-trip): it is the cost the deadline
            # policy must budget for, not just device time
            t0 = self._clock()
            if host is not None:
                labels = host.eval(tenant.worker_key, x)
            else:
                labels = replica.engine.classify_batch(x)
            dt = self._clock() - t0
        except Exception as exc:        # complete exceptionally, never hang
            msg = f"{type(exc).__name__}: {exc}"
            if not is_shadow:
                self.errors.append(f"{tenant.name}: {msg}")
            for r in reqs:
                r.error = msg
                r._complete()
            return False
        tenant.est_dispatch_s = 0.7 * tenant.est_dispatch_s + 0.3 * dt
        tenant.last_dispatch_s = dt
        if not is_shadow:
            self.stats.record(len(reqs), dt)
        tenant.stats.record(len(reqs), dt)
        if host is not None:
            # keep the replica-level ledger honest in worker mode too:
            # timing/labels came from the worker proc, but the attach path
            # (label, latency, request stats) is identical
            replica.engine.stats.record(len(reqs), dt)
        # FleetRequest carries the same completion fields as SensorRequest,
        # so the engine's label/latency attach is reused verbatim (request
        # stats land on the replica's engine; tenant + fleet get them here)
        replica.engine.complete(reqs, labels)
        for r in reqs:
            if not is_shadow:
                self.stats.record_request(r.latency_ms, r.deadline_ms)
            tenant.stats.record_request(r.latency_ms, r.deadline_ms)
            r._complete()
        return True

    def _dispatch_fused(self, jobs: list) -> bool:
        """Serve MANY tenants' popped batches in one megakernel launch.

        `jobs` is `[(tenant, replica, entries), ...]` — every due tenant
        of this device's scheduler pass.  Each tenant's batch is binarized
        with its own ABC thresholds, padded to its engine's `max_batch`
        and bit-packed on the device (`prepare_packed_batch`), and the
        tenants go through `kernels.dispatch.fleet_eval_words` as ONE
        launch, in name order: the padded plans and their schedule are
        cached by the set of plans, so a set of tenants costs one padding
        however the scheduler ordered them.  Per-tenant accounting mirrors
        `_dispatch`: every tenant is charged the full launch wall time
        (that IS the latency its batch paid), the fleet-level batch sample
        is recorded once per launch, and shadows stay out of fleet stats
        and the error log.  A launch failure fails every request of every
        job — the whole launch is the unit of execution.
        """
        from repro_torch.kernels import dispatch as D

        jobs = sorted(jobs, key=lambda j: j[0].name)
        prepared = []
        try:
            plans, words_list = [], []
            for tenant, replica, entries in jobs:
                reqs = [e.item for e in entries]
                words32, B = replica.engine.prepare_packed_batch(
                    self._gather_batch(reqs))
                plans.append(replica.engine.program.plan())
                words_list.append(words32)
                prepared.append((tenant, replica, reqs, B))
            t0 = self._clock()
            outs = D.fleet_eval_words(plans, words_list,
                                      device=jobs[0][1].engine.program.device)
            dt = self._clock() - t0
        except Exception as exc:        # complete exceptionally, never hang
            msg = f"megakernel: {type(exc).__name__}: {exc}"
            for tenant, replica, entries in jobs:
                if tenant.shadow_of is None:
                    self.errors.append(f"{tenant.name}: {msg}")
                for e in entries:
                    e.item.error = msg
                    e.item._complete()
            return False
        live_readings = sum(len(reqs) for t, _, reqs, _ in prepared
                            if t.shadow_of is None)
        if live_readings:
            self.stats.record(live_readings, dt)   # one launch = one batch
        self._megakernel_launches += 1
        self._megakernel_peak_tenants = max(self._megakernel_peak_tenants,
                                            len(jobs))
        for (tenant, replica, reqs, B), out in zip(prepared, outs):
            labels = np.asarray(out[:B], dtype=np.int32)
            is_shadow = tenant.shadow_of is not None
            tenant.est_dispatch_s = 0.7 * tenant.est_dispatch_s + 0.3 * dt
            tenant.last_dispatch_s = dt
            tenant.stats.record(len(reqs), dt)
            replica.engine.stats.record(len(reqs), dt)
            replica.engine.complete(reqs, labels)
            for r in reqs:
                if not is_shadow:
                    self.stats.record_request(r.latency_ms, r.deadline_ms)
                tenant.stats.record_request(r.latency_ms, r.deadline_ms)
                r._complete()
        return True

    def _device_worker(self, device: str) -> _DeviceWorker:
        """`device`'s scheduler, started now if the fleet runs and it is
        new (caller holds `_admin_lock`)."""
        worker = self._workers.get(device)
        if worker is None:
            worker = _DeviceWorker(self, device, [])
            self._workers[device] = worker
            if self._started:
                worker.start()
        return worker

    # -- shadow deployment ---------------------------------------------------
    def deploy_shadow(self, spec: TenantSpec, of: str) -> ShadowComparator:
        """Stand up `spec` as a **shadow replica** of live tenant `of`.

        The shadow gets its own replica pool and queue on its device's
        scheduler but is not routable: it only ever sees copies of traffic
        admitted for `of` (`_mirror`), and its dispatches stay out of the
        fleet's stats and error log.  Returns the `ShadowComparator`
        accumulating agreement/accuracy/latency deltas — the evidence a
        promotion decision is made from.  One shadow per incumbent; give
        the shadow's `max_queue` a value to bound mirror backlog (excess
        mirrors are dropped, never backpressured).
        """
        with self._admin_lock:
            if self._shutdown:
                raise RuntimeError("fleet is shut down")
            incumbent = self._tenant(of)
            if of in self._shadows:
                raise ValueError(
                    f"tenant {of!r} already has a shadow "
                    f"({self._shadows[of].name!r}); retire it first")
            if spec.name in self._tenants or any(
                    s.name == spec.name for s in self._shadows.values()):
                raise ValueError(f"name {spec.name!r} is already in use")
            t = self._build_tenant(spec)    # warmup outside any worker lock
            if t.engine.n_features != incumbent.engine.n_features:
                raise ValueError(
                    f"shadow {spec.name!r} expects {t.engine.n_features} "
                    f"features but incumbent {of!r} serves "
                    f"{incumbent.engine.n_features}")
            t.shadow_of = of
            t.comparator = ShadowComparator(of, spec.name,
                                            window=self.stats_window)
            worker = self._device_worker(t.device_key)
            with worker.cond:
                self._shadows[of] = t
                worker.tenants.append(t)
                worker.cond.notify_all()
            return t.comparator

    def shadow_comparator(self, of: str) -> ShadowComparator:
        t = self._shadows.get(of)
        if t is None:
            raise KeyError(f"tenant {of!r} has no shadow; shadowed: "
                           f"{', '.join(sorted(self._shadows)) or '(none)'}")
        return t.comparator

    def retire_shadow(self, of: str, timeout: float = 30.0) -> dict:
        """Tear down `of`'s shadow; returns the comparator's final summary.

        Mirroring stops immediately; the queued mirror backlog is served
        (so every expected pair closes) before the pool is dropped.  Both
        the rollback path and the promotion path end here — promotion
        additionally re-registers the winner under the incumbent's name
        and `sync_manifest()`s it into the serving slot.
        """
        with self._admin_lock:
            t = self._shadows.pop(of, None)
            if t is None:
                raise KeyError(f"tenant {of!r} has no shadow")
            worker = self._worker_of(t)
            with worker.cond:
                t.retiring = True
                worker.cond.notify_all()
        deadline = self._clock() + timeout
        with worker.cond:
            while t in worker.tenants:
                left = deadline - self._clock()
                if left <= 0:
                    raise TimeoutError(
                        f"shadow of {of!r} still draining after {timeout}s "
                        f"({len(t.batcher)} queued)")
                worker.cond.wait(min(left, 0.05))
        return t.comparator.summary()

    # -- hot reload ----------------------------------------------------------
    def add_tenant(self, spec: TenantSpec) -> None:
        """Stand up a new tenant without draining anything."""
        with self._admin_lock:
            # shutdown() flips the flag under this lock, so checking here
            # can't race a concurrent shutdown into leaking a worker
            # thread that nobody will ever stop
            if self._shutdown:
                raise RuntimeError("fleet is shut down")
            if spec.name in self._tenants:
                raise ValueError(f"tenant {spec.name!r} already exists "
                                 "(use replace_tenant)")
            t = self._build_tenant(spec)    # warmup outside any worker lock
            worker = self._device_worker(t.device_key)
            with worker.cond:
                self._tenants[spec.name] = t
                worker.tenants.append(t)
                worker.cond.notify_all()

    def replace_tenant(self, spec: TenantSpec) -> None:
        """Swap a tenant for a new program/config without dropping requests.

        Queued requests transfer to the successor (original submit times
        and budgets intact) when the feature count still matches; batches
        already in flight finish on the old replicas.  The old pool drains
        and is dropped by its scheduler.
        """
        with self._admin_lock:
            if self._shutdown:
                raise RuntimeError("fleet is shut down")
            old = self._tenant(spec.name)
            new = self._build_tenant(spec)
            new.from_manifest = old.from_manifest
            old_worker = self._worker_of(old)
            new_worker = self._device_worker(new.device_key)
            first, second = ((old_worker, new_worker)
                             if id(old_worker) <= id(new_worker)
                             else (new_worker, old_worker))
            with first.cond:
                ctx = second.cond if second is not first else \
                    threading.Lock()        # dummy when same worker
                with ctx:
                    moved = [e for b in old.batcher.drain() for e in b]
                    compatible = (new.engine.n_features
                                  == old.engine.n_features)
                    if compatible:
                        new.batcher.adopt(moved)
                    self._tenants[spec.name] = new
                    new_worker.tenants.append(new)
                    old.retiring = True
                    old_worker.cond.notify_all()
                    new_worker.cond.notify_all()
            if not compatible:
                for e in moved:
                    e.item.error = (f"tenant {spec.name!r} replaced with an "
                                    f"incompatible feature count")
                    e.item._complete()

    def retire_tenant(self, name: str, timeout: float = 30.0) -> None:
        """Remove a tenant: refuse new submits, serve the backlog, drop it."""
        with self._admin_lock:
            t = self._tenant(name)
            worker = self._worker_of(t)
            with worker.cond:
                del self._tenants[name]
                t.retiring = True
                worker.cond.notify_all()
        deadline = self._clock() + timeout
        with worker.cond:
            while t in worker.tenants:
                left = deadline - self._clock()
                if left <= 0:
                    raise TimeoutError(
                        f"tenant {name!r} still draining after {timeout}s "
                        f"({len(t.batcher)} queued)")
                worker.cond.wait(min(left, 0.05))

    def sync_manifest(self) -> dict:
        """Reconcile live tenants with the emit dir's current `fleet.json`.

        Only fleets built by `from_emit_dir` can sync.  Returns the action
        summary `{"added": [...], "replaced": [...], "retired": [...],
        "generation": N}` — empty lists mean the manifest generation
        matched and nothing moved.
        """
        if self._manifest_ctx is None:
            raise RuntimeError("fleet was not built from an emit dir; "
                               "nothing to sync against")
        with self._sync_lock:
            return self._sync_manifest_locked()

    def _sync_manifest_locked(self) -> dict:
        ctx = self._manifest_ctx
        doc = load_manifest_doc(ctx["emit_dir"])
        actions = {"added": [], "replaced": [], "retired": [],
                   "generation": doc.get("generation", 0)}
        rows = {r["name"]: r for r in doc["tenants"]}
        if ctx["tenants"] is not None:
            rows = {n: r for n, r in rows.items() if n in ctx["tenants"]}
        for name in sorted(set(self._tenants) - set(rows)):
            if self._tenants[name].from_manifest:
                self.retire_tenant(name)
                actions["retired"].append(name)
        for name, row in sorted(rows.items()):
            cur = self._tenants.get(name)
            if cur is None:
                spec = self._spec_from_row(row, ctx)
                self.add_tenant(spec)
                self._tenants[name].from_manifest = True
                actions["added"].append(name)
            elif int(row.get("generation", 0)) != cur.spec.generation:
                self.replace_tenant(self._spec_from_row(row, ctx))
                actions["replaced"].append(name)
        self._manifest_generation = actions["generation"]
        return actions

    # -- autoscaling ---------------------------------------------------------
    def _tenant_signals(self) -> list[TenantSignals]:
        """Snapshot every tenant's control signals (one round's input).

        Each tenant is read under its device's scheduler condition so
        queue depth / inflight / shed counters are mutually consistent;
        the per-round deltas are kept on the tenant so a tick sees only
        what happened since the previous tick.
        """
        signals = []
        live = list(self._tenants.values()) + list(self._shadows.values())
        for t in live:
            worker = self._worker_of(t)
            with worker.cond:
                s = t.stats.summary()
                shed, nreq = s["n_shed"], s["n_requests"]
                spec = t.spec
                signals.append(TenantSignals(
                    name=t.name,
                    pool_size=t.pool.size,
                    queue_depth=len(t.batcher),
                    inflight=t.pool.total_inflight,
                    shed_delta=shed - t._as_last_shed,
                    request_delta=nreq - t._as_last_requests,
                    est_dispatch_ms=max(t.est_dispatch_s,
                                        t.last_dispatch_s) * 1e3,
                    max_batch=spec.max_batch,
                    max_queue=spec.max_queue,
                    min_replicas=spec.min_replicas or 1,
                    max_replicas=(spec.max_replicas
                                  if spec.max_replicas is not None
                                  else spec.replicas),
                    is_shadow=t.shadow_of is not None))
                t._as_last_shed = shed
                t._as_last_requests = nreq
        return signals

    def autoscale_tick(self) -> list[dict]:
        """One autoscaler round: observe signals, resize pools, log events.

        Deterministic given the fleet's state — the background loop calls
        it on a timer, and tests call it directly to step the controller a
        bounded number of rounds with zero wall-clock dependence.  Returns
        the applied actions (also appended to the bounded event log
        surfaced by `stats_summary`).
        """
        if self._autoscaler is None:
            return []
        actions = self._autoscaler.observe(self._tenant_signals())
        applied = []
        for act in actions:
            t = self._tenants.get(act.name)
            if t is None or t.retiring:
                continue        # retired/replaced between snapshot and apply
            n = (self._grow_tenant(t, act.delta) if act.delta > 0
                 else self._shrink_tenant(t))
            if n:
                applied.append({**act.as_dict(), "applied": n,
                                "pool_size": t.pool.size})
        if applied:
            self._scale_events.extend(applied)
            del self._scale_events[:-256]
        return applied

    def _grow_tenant(self, t: _Tenant, k: int) -> int:
        """Add `k` replicas to `t`'s pool; engines are built (and warmed)
        outside the scheduler lock so growth never stalls dispatch."""
        worker = self._worker_of(t)
        with worker.cond:
            base = t.pool.next_index()
        fresh = []
        for i in range(k):
            rep = make_replica(t.spec.program, base + i, t.spec.max_batch,
                               stats_window=self.stats_window,
                               devices=(t.device,))
            # in worker mode the subprocess engines are already warm; the
            # fleet-side replica is only a concurrency token + ledger
            if self.warmup_on_load and t.worker_key is None:
                rep.engine.warmup()
            fresh.append(rep)
        with worker.cond:
            if self._tenants.get(t.name) is not t or t.retiring:
                return 0
            for rep in fresh:
                t.pool.grow(rep)
            worker.cond.notify_all()    # saturated pickers may proceed now
        return len(fresh)

    def _shrink_tenant(self, t: _Tenant) -> int:
        worker = self._worker_of(t)
        with worker.cond:
            if self._tenants.get(t.name) is not t or t.retiring:
                return 0
            dropped = t.pool.shrink_idle()
        return 1 if dropped is not None else 0

    @property
    def autoscale_events(self) -> list[dict]:
        return list(self._scale_events)

    # -- drain / shutdown ----------------------------------------------------
    def flush(self, timeout: float | None = 30.0) -> None:
        """Force-dispatch the whole backlog and wait until it is served.

        Waits on queued *and* in-flight work: a request popped by a worker
        just before flush() is called is still awaited (workers notify the
        condition after every dispatch completes).
        """
        deadline = None if timeout is None else self._clock() + timeout
        for w in list(self._workers.values()):
            with w.cond:
                w.kick = True
                w.cond.notify_all()
        try:
            for w in list(self._workers.values()):
                with w.cond:
                    while w.queued() or w.in_flight:
                        left = (None if deadline is None
                                else deadline - self._clock())
                        if left is not None and left <= 0:
                            raise TimeoutError(
                                f"flush: {w.queued()} queued + "
                                f"{w.in_flight} in-flight requests still "
                                f"pending on device {w.device}")
                        w.cond.wait(0.05 if left is None
                                    else min(left, 0.05))
        finally:
            for w in list(self._workers.values()):
                with w.cond:
                    w.kick = False

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop dispatch threads; `drain` serves the backlog first."""
        with self._admin_lock:      # serialized against add/replace, so no
            if self._shutdown:      # worker can be created+started after
                return              # the flag flips
            self._shutdown = True
        self._autoscale_stop.set()
        if self._autoscale_thread is not None:
            self._autoscale_thread.join(timeout=5.0)
        for w in self._workers.values():
            with w.cond:
                if not drain:       # cancel the backlog deterministically
                    for t in w.tenants:
                        for batch in t.batcher.drain():
                            for e in batch:
                                e.item.error = "cancelled at shutdown"
                                e.item._complete()
                w.stop = True
                w.cond.notify_all()
        if self._started:
            for w in self._workers.values():
                w.join(timeout)
                if w.is_alive():
                    raise TimeoutError(f"worker {w.name} did not stop "
                                       f"within {timeout}s")
        # dispatch threads are parked; the worker procs have nothing in
        # flight and can be torn down (slabs unlink here too)
        for host in self._worker_hosts.values():
            host.close()

    # -- observability -------------------------------------------------------
    def stats_summary(self) -> dict:
        """Fleet-wide + per-tenant (+ per-replica) `ServeStats` summaries.

        Each tenant row carries its *deploy identity* — the artifact
        sha256 its manifest row recorded and the manifest generation the
        fleet last synced to — so an operator (or the autopilot) can tell
        exactly which emitted design is live without touching the emit
        dir.  Tenants with a live shadow get a `"shadow"` sub-dict with
        the comparator's running verdict evidence.

        The snapshot is *consistent*: every device's scheduler condition
        is held (in one canonical order, so this cannot deadlock against
        `replace_tenant`'s two-lock ordering) while the rows are read,
        so a STATS frame served from a sharded accept loop can never
        report a queue depth from mid-admission or a fleet shed total
        that disagrees with the per-tenant sheds it sums over.
        """
        # snapshot the worker set first — admin ops may add workers, and
        # new workers start with no tenants, so missing a *brand-new*
        # device only means its (empty) tenants appear next call
        workers = sorted(self._workers.values(), key=id)
        with contextlib.ExitStack() as stack:
            for w in workers:
                stack.enter_context(w.cond)
            tenants = {}
            for name, t in sorted(self._tenants.items()):
                row = {
                    "device": t.device_key,
                    "max_batch": t.spec.max_batch,
                    "deadline_ms": t.spec.deadline_ms,
                    "max_queue": t.spec.max_queue,
                    "dataset": t.spec.dataset,
                    "generation": t.spec.generation,
                    "sha256": t.spec.sha256,
                    "qos": t.spec.qos,
                    "rate_limit_rps": t.spec.rate_limit_rps,
                    "pool_size": t.pool.size,
                    "pending": len(t.batcher),
                    "replicas": t.pool.summary(),
                    **t.stats.summary(),
                }
                sh = self._shadows.get(name)
                if sh is not None:
                    row["shadow"] = {
                        "name": sh.name,
                        "device": sh.device_key,
                        "sha256": sh.spec.sha256,
                        "pending": len(sh.batcher),
                        **sh.comparator.summary(),
                    }
                tenants[name] = row
            out = {
                "fleet": self.stats.summary(),
                "manifest_generation": self._manifest_generation,
                "tenants": tenants,
            }
            if self.megakernel:
                out["megakernel"] = {
                    "launches": self._megakernel_launches,
                    "peak_tenants_per_launch": self._megakernel_peak_tenants,
                }
        if self._worker_hosts:
            out["workers"] = {b: h.summary()
                              for b, h in sorted(self._worker_hosts.items())}
        if self._autoscaler is not None:
            out["autoscale"] = {**self._autoscaler.summary(),
                                "events": self.autoscale_events[-16:]}
        return out
