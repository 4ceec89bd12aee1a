"""Per-tenant engine replica pools: least-loaded pick, device round-robin.

The port of `repro.serve.replicas`.  A `ReplicaPool` runs N engines over
the *same* compiled classifier behind the tenant's one micro-batch queue:
the fleet scheduler acquires the least-loaded idle replica for each due
batch, so two due batches of the same tenant overlap on different
replicas.  Replica i's program is a clone pinned to
`kernels.dispatch.replica_devices(i, devices)`: with `devices=None` the
CUDA devices round-robin (none is an error), and a replica lands on the
CPU only when the caller lists it.  On a one-card host every replica
lands on the same card, where each launches on its dispatch thread's
current stream.

The pick policy is pure bookkeeping with no threads or clocks in it —
`acquire`/`release` mutate integer counters under whatever lock the
caller already holds (the fleet holds its scheduler condition) — so the
tests drive arbitrary acquire/release schedules through the exact
production code and pin the invariants:

  * **work conserving** — `acquire` refuses only when *every* replica is
    busy; an idle replica is always handed out;
  * **least-loaded** — among idle replicas the one with the fewest total
    dispatched readings wins (index breaks ties), so sustained load
    spreads over the whole pool and no replica starves;
  * **conservation** — readings handed out equal readings accounted *for
    dispatches that succeeded*: `release` takes the outcome and credits a
    failed dispatch's readings back, so a replica whose dispatches error
    does not look permanently loaded; `inflight` returns to zero once
    every dispatch is released.

The pool is also elastic: the autoscaler appends replicas with `grow`
and retires idle ones with `shrink_idle` under the same caller-held
lock.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serve.engine import STATS_WINDOW, CircuitServingEngine


def make_replica(program, index: int, max_batch: int,
                 stats_window: int = STATS_WINDOW,
                 devices=None) -> "EngineReplica":
    """One fresh replica of `program` pinned to device slot `index` of
    `devices` (None: the CUDA devices).

    Shared by `ReplicaPool.from_program` (initial sizing) and the fleet's
    autoscaler (incremental growth), so grown replicas get the identical
    clone + device round-robin treatment as boot-time ones.
    """
    from repro_torch.compile.program import CircuitProgram
    from repro_torch.kernels.dispatch import replica_devices

    pinned = replica_devices(index, devices)
    prog = CircuitProgram(ir=program.ir, thresholds=program.thresholds,
                          n_classes=program.n_classes, device=pinned[0])
    return EngineReplica(
        index=index,
        engine=CircuitServingEngine(prog, max_batch,
                                    stats_window=stats_window),
        devices=pinned)


@dataclass
class EngineReplica:
    """One engine of a tenant's pool + its scheduling counters."""

    index: int
    engine: CircuitServingEngine
    devices: tuple | None = None
    inflight: int = 0            # dispatches currently executing
    n_dispatches: int = 0        # total batches handed to this replica
    n_readings: int = 0          # total readings handed to this replica
    n_errors: int = 0            # dispatches that ended in an error
    meta: dict = field(default_factory=dict)

    @property
    def busy(self) -> bool:
        return self.inflight > 0

    def summary(self) -> dict:
        return {
            "index": self.index,
            "devices": [str(d) for d in (self.devices or ())],
            "inflight": self.inflight,
            "n_dispatches": self.n_dispatches,
            "n_readings": self.n_readings,
            "n_errors": self.n_errors,
            **{k: self.engine.stats.summary()[k]
               for k in ("busy_s", "readings_per_s", "p50_ms", "p99_ms")},
        }


class ReplicaPool:
    """Least-loaded routing over N replicas of one compiled classifier."""

    def __init__(self, replicas: list[EngineReplica]):
        if not replicas:
            raise ValueError("a replica pool needs at least one replica")
        self.replicas = list(replicas)

    @classmethod
    def from_program(cls, program, n_replicas: int, max_batch: int,
                     stats_window: int = STATS_WINDOW,
                     devices=None) -> "ReplicaPool":
        """Clone `program` into `n_replicas` engines, replica i on device
        ``i % len(devices)`` (`devices=None`: the CUDA devices)."""
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        return cls([make_replica(program, i, max_batch,
                                 stats_window=stats_window, devices=devices)
                    for i in range(n_replicas)])

    @property
    def size(self) -> int:
        return len(self.replicas)

    def idle(self) -> bool:
        return all(r.inflight == 0 for r in self.replicas)

    def has_idle(self) -> bool:
        return any(r.inflight == 0 for r in self.replicas)

    @property
    def total_inflight(self) -> int:
        return sum(r.inflight for r in self.replicas)

    def acquire(self, n_readings: int = 0) -> EngineReplica | None:
        """Claim the least-loaded idle replica for a batch of `n_readings`.

        Returns None iff every replica is mid-dispatch (the scheduler then
        leaves the batch queued and retries when a release notifies it).
        Load is total readings ever handed out — not inflight count — so
        ties from identical batch sizes rotate deterministically by index.
        """
        idle = [r for r in self.replicas if r.inflight == 0]
        if not idle:
            return None
        pick = min(idle, key=lambda r: (r.n_readings, r.index))
        pick.inflight += 1
        pick.n_dispatches += 1
        pick.n_readings += n_readings
        return pick

    def release(self, replica: EngineReplica, n_readings: int = 0,
                ok: bool = True) -> None:
        """Return a replica after its dispatch, reconciling the outcome.

        A failed dispatch did no useful work: its `n_readings` charge
        (made optimistically at `acquire` time) is credited back so the
        least-loaded pick keeps routing *to* — not away from — a replica
        that errored, instead of treating the failure as served load.
        """
        if replica.inflight <= 0:
            raise ValueError(f"replica {replica.index} released while idle")
        replica.inflight -= 1
        if not ok:
            replica.n_errors += 1
            replica.n_readings -= min(int(n_readings), replica.n_readings)

    def grow(self, replica: EngineReplica) -> EngineReplica:
        """Append an autoscaler-built replica (caller holds the lock)."""
        self.replicas.append(replica)
        return replica

    def next_index(self) -> int:
        """Device-slot index for the next grown replica.

        Indices stay monotonic across shrink/grow cycles so device
        pinning never doubles up with a still-live replica's slot.
        """
        return max(r.index for r in self.replicas) + 1

    def shrink_idle(self) -> EngineReplica | None:
        """Retire one idle replica (highest index first), if any.

        Returns None — and the pool is untouched — when every replica is
        mid-dispatch or the pool is already at one replica; the caller
        (autoscaler tick) just retries on a later round.
        """
        if len(self.replicas) <= 1:
            return None
        idle = [r for r in self.replicas if r.inflight == 0]
        if not idle:
            return None
        drop = max(idle, key=lambda r: r.index)
        self.replicas.remove(drop)
        return drop

    def summary(self) -> list[dict]:
        return [r.summary() for r in self.replicas]
