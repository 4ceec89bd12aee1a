"""Deadline-driven micro-batching: the fleet's flush policy as pure logic.

The port's copy of `repro.serve.batcher`, as it is.

A tenant's queue used to be drained by a manual `flush()` call; the fleet
replaces that with a policy object that decides *when* a batch is due:

  * **full**     — `max_batch` requests are queued (amortization can't
    improve further, ship it), or
  * **deadline** — the oldest queued request could not sit through one more
    dispatch interval without busting its latency budget (waiting any
    longer would convert a possible hit into a certain miss).

The policy is deliberately free of threads and wall clocks — callers pass
`now` explicitly (the fleet passes `time.perf_counter()`, the property
tests a fake clock), and callers synchronize access (the fleet holds its
scheduler condition around every call).  That split is what lets the
hypothesis suite drive arbitrary arrival orders, batch sizes and budgets
through the exact production decision code with zero timing flake.

Invariants (pinned by tests/test_serve_fleet.py):
  * batches are formed in arrival order and never reordered within a
    tenant;
  * no batch exceeds `max_batch`;
  * `drain()` empties the queue, in order, on shutdown.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator


@dataclass
class QueuedItem:
    """One queued request: payload + the timing the flush policy needs."""

    item: Any
    t_submit: float
    deadline_s: float          # latency budget, seconds from t_submit

    @property
    def due_at(self) -> float:
        return self.t_submit + self.deadline_s


class MicroBatcher:
    """Arrival-order queue with the full-or-deadline flush policy."""

    def __init__(self, max_batch: int, default_deadline_ms: float):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if default_deadline_ms <= 0:
            raise ValueError("deadline budget must be positive")
        self.max_batch = max_batch
        self.default_deadline_ms = default_deadline_ms
        self._queue: deque[QueuedItem] = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def __iter__(self) -> Iterator[QueuedItem]:
        return iter(self._queue)

    def submit(self, item: Any, now: float,
               deadline_ms: float | None = None) -> QueuedItem:
        deadline_ms = (self.default_deadline_ms if deadline_ms is None
                       else deadline_ms)
        if deadline_ms <= 0:
            raise ValueError("deadline budget must be positive")
        entry = QueuedItem(item, now, deadline_ms * 1e-3)
        self._queue.append(entry)
        return entry

    def submit_many(self, items: list, now: float,
                    deadlines_ms=None) -> list[QueuedItem]:
        """Enqueue a whole batched frame as one contiguous arrival-order run.

        The ingest fast path: the fleet holds its scheduler lock exactly
        once per *frame* instead of once per reading.  `deadlines_ms` is
        None (every row gets the default budget) or one value per item,
        where NaN rows fall back to the default — the v2 wire encoding.
        All rows share one `t_submit`, which is what "arrived as one
        frame" means to the flush policy.

        Admission is all-or-nothing per frame: the entire deadline table
        is validated before any entry is constructed, so a bad row late
        in the frame cannot leave earlier rows materialized (let alone
        enqueued) while the caller sees a ValueError.
        """
        default_s = self.default_deadline_ms * 1e-3
        if deadlines_ms is None:
            entries = [QueuedItem(item, now, default_s) for item in items]
        else:
            if len(deadlines_ms) != len(items):
                raise ValueError(f"{len(deadlines_ms)} deadlines for "
                                 f"{len(items)} items")
            budgets_s = []
            for d in deadlines_ms:
                d = float(d)
                if d != d:                  # NaN -> tenant default
                    budgets_s.append(default_s)
                elif d <= 0:
                    raise ValueError("deadline budget must be positive")
                else:
                    budgets_s.append(d * 1e-3)
            entries = [QueuedItem(item, now, b)
                       for item, b in zip(items, budgets_s)]
        self._queue.extend(entries)
        return entries

    def adopt(self, entries: list[QueuedItem]) -> None:
        """Take over already-timed entries from another batcher, in order.

        The hot-reload transfer path: when a tenant is replaced, its
        queued-but-undispatched requests move to the successor's queue
        with their original submit times and budgets intact, so a reload
        never resets anyone's deadline clock.
        """
        self._queue.extend(entries)

    @property
    def oldest_due_at(self) -> float | None:
        return self._queue[0].due_at if self._queue else None

    def due(self, now: float, est_dispatch_s: float = 0.0) -> bool:
        """Is a batch due right now (full, or oldest about to bust budget)?"""
        if len(self._queue) >= self.max_batch:
            return True
        if not self._queue:
            return False
        return now + est_dispatch_s >= self._queue[0].due_at

    def next_due_at(self, est_dispatch_s: float = 0.0) -> float | None:
        """Earliest instant `due` can flip true without new arrivals."""
        if not self._queue:
            return None
        if len(self._queue) >= self.max_batch:
            return self._queue[0].t_submit        # already due (in the past)
        return self._queue[0].due_at - est_dispatch_s

    def pop_batch(self) -> list[QueuedItem]:
        """Up to `max_batch` oldest entries, in arrival order."""
        n = min(len(self._queue), self.max_batch)
        return [self._queue.popleft() for _ in range(n)]

    def drain(self) -> list[list[QueuedItem]]:
        """Everything left, as consecutive arrival-order batches."""
        batches = []
        while self._queue:
            batches.append(self.pop_batch())
        return batches
