"""Sensor-stream classification serving on compiled circuit programs.

The port's `repro.serve.engine`.  There is no decode loop — every request
is one sensor reading classified in a single circuit pass — so the
engine's job is batching: queued readings are gathered in arrival order
into padded batches of `max_batch` rows, dispatched as one bit-packed
evaluation on the program's device, and the labels scattered back with
per-request latency.  The timed region of a dispatch ends after the labels
are on the host, so `ServeStats` includes the card's work.

`classify_stream` is the bulk path; `submit`/`flush` the request-queue
path (thread-safe: concurrent `flush` calls partition the queue instead of
double-dispatching it).  `prepare_packed_batch` is the megakernel half of
`classify_batch`: it stops at the packed word plane, which
`kernels.dispatch.fleet_eval_words` takes for many tenants at once.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.compile.program import CircuitProgram

STATS_WINDOW = 4096


class _Ring:
    """Fixed-capacity ring of float samples (keeps the most recent N).

    Long-running streams push one batch sample per dispatch; an unbounded
    list grows without limit (and made every percentile call slower), so
    percentiles are computed over a sliding window instead.  Totals that
    must stay exact (counts, busy seconds) live outside the ring.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._pushed = 0

    def push(self, v: float) -> None:
        self._buf[self._pushed % self._buf.shape[0]] = v
        self._pushed += 1

    def __len__(self) -> int:
        return min(self._pushed, self._buf.shape[0])

    @property
    def total_pushed(self) -> int:
        return self._pushed

    def values(self) -> np.ndarray:
        return self._buf[: len(self)]

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values(), q)) if len(self) else 0.0

    def max(self) -> float:
        return float(self.values().max()) if len(self) else 0.0


class ServeStats:
    """Throughput + latency accounting for one engine (or a whole fleet).

    Batch samples (one per dispatch) and request samples (one per queued
    request) are kept in bounded rings of `window` entries, so a stream of
    millions of readings holds stats memory constant; counters and busy
    time are exact over the full stream.  `n_shed` counts submissions the
    admission controller rejected (they never enter the request rings, so
    p50/p99 describe *accepted* traffic only).  Thread-safe: dispatch
    threads and stat readers may interleave freely.
    """

    def __init__(self, window: int = STATS_WINDOW):
        self.window = window
        self.n_readings = 0
        self.n_batches = 0
        self.busy_s = 0.0                 # time spent inside dispatches
        self.n_requests = 0
        self.n_slo_miss = 0               # requests finishing past deadline
        self.n_shed = 0                   # submissions refused at admission
        self.batch_ms = _Ring(window)     # per-dispatch wall time
        self.request_ms = _Ring(window)   # per-request submit -> label
        self._lock = threading.Lock()

    def record(self, n: int, dt_s: float) -> None:
        with self._lock:
            self.n_readings += n
            self.n_batches += 1
            self.busy_s += dt_s
            self.batch_ms.push(dt_s * 1e3)

    def record_request(self, latency_ms: float,
                       deadline_ms: float | None = None) -> None:
        with self._lock:
            self.n_requests += 1
            self.request_ms.push(latency_ms)
            if deadline_ms is not None and latency_ms > deadline_ms:
                self.n_slo_miss += 1

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.n_shed += n

    @property
    def readings_per_s(self) -> float:
        return self.n_readings / self.busy_s if self.busy_s > 0 else 0.0

    def percentile_ms(self, q: float) -> float:
        return self.batch_ms.percentile(q)

    def request_percentile_ms(self, q: float) -> float:
        return self.request_ms.percentile(q)

    def summary(self) -> dict:
        with self._lock:
            return {
                "n_readings": self.n_readings,
                "n_batches": self.n_batches,
                "busy_s": round(self.busy_s, 6),
                "readings_per_s": round(self.readings_per_s, 1),
                "p50_ms": round(self.batch_ms.percentile(50), 4),
                "p99_ms": round(self.batch_ms.percentile(99), 4),
                "n_requests": self.n_requests,
                "req_p50_ms": round(self.request_ms.percentile(50), 4),
                "req_p99_ms": round(self.request_ms.percentile(99), 4),
                "n_slo_miss": self.n_slo_miss,
                "n_shed": self.n_shed,
                "window": self.window,
            }


@dataclass
class SensorRequest:
    uid: int
    readings: np.ndarray             # (F,) raw sensor values
    label: int | None = None
    latency_ms: float | None = None  # submit -> label
    deadline_ms: float | None = None  # latency budget (SLO), if any
    _t_submit: float = 0.0

    @property
    def slo_miss(self) -> bool:
        return (self.deadline_ms is not None and self.latency_ms is not None
                and self.latency_ms > self.deadline_ms)


class CircuitServingEngine:
    """Batched request->label serving over one compiled classifier."""

    def __init__(self, program: CircuitProgram, max_batch: int = 1024,
                 stats_window: int = STATS_WINDOW):
        if program.n_classes is None:
            raise ValueError("engine needs a classifier program")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.program = program
        self.max_batch = max_batch
        self.stats = ServeStats(window=stats_window)
        self._queue: list[SensorRequest] = []
        self._next_uid = 0
        self._lock = threading.Lock()

    @property
    def n_features(self) -> int:
        return self.program.ir.n_inputs

    def warmup(self) -> float:
        """Run the fixed batch shape twice (not counted in the stats).

        The first call builds and loads the kernel on the card; returns the
        wall time of the second, warm dispatch in seconds.
        """
        dummy = np.zeros((self.max_batch, self.n_features), dtype=np.float64)
        for _ in range(2):
            t0 = time.perf_counter()
            self._labels(dummy)
            dt = time.perf_counter() - t0
        return dt

    # -- request-queue path -------------------------------------------------
    def submit(self, readings: np.ndarray,
               deadline_ms: float | None = None) -> SensorRequest:
        readings = np.asarray(readings, dtype=np.float64).reshape(-1)
        if readings.shape[0] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, "
                             f"got {readings.shape[0]}")
        with self._lock:
            req = SensorRequest(self._next_uid, readings,
                                deadline_ms=deadline_ms,
                                _t_submit=time.perf_counter())
            self._next_uid += 1
            self._queue.append(req)
        return req

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def _pop_group(self) -> list[SensorRequest]:
        with self._lock:
            group = self._queue[: self.max_batch]
            del self._queue[: len(group)]
        return group

    def flush(self) -> list[SensorRequest]:
        """Drain the queue in arrival order; returns the completed requests.

        Each batch is popped atomically before dispatch, so requests that
        arrive while a dispatch is in flight — or a second flusher running
        concurrently — find the queue consistent: every request is
        dispatched exactly once and completes with `label` and
        `latency_ms` set.
        """
        done: list[SensorRequest] = []
        while True:
            group = self._pop_group()
            if not group:
                break
            x = np.stack([r.readings for r in group])
            self.complete(group, self._dispatch(x))
            done.extend(group)
        return done

    def complete(self, group: list[SensorRequest],
                 labels: np.ndarray) -> None:
        """Attach labels + latency to dispatched requests (stats included)."""
        t_done = time.perf_counter()
        for r, lbl in zip(group, labels):
            r.label = int(lbl)
            r.latency_ms = (t_done - r._t_submit) * 1e3
            self.stats.record_request(r.latency_ms, r.deadline_ms)

    # -- bulk path ----------------------------------------------------------
    def _check_readings(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(f"expected (S, {self.n_features}) readings, "
                             f"got {x.shape}")
        return x

    def _check_batch(self, x) -> np.ndarray:
        x = self._check_readings(x)
        if x.shape[0] > self.max_batch:
            raise ValueError(f"batch of {x.shape[0]} exceeds max_batch "
                             f"{self.max_batch}")
        return x

    def classify_stream(self, x: np.ndarray) -> np.ndarray:
        """Classify `(S, F)` readings in max_batch chunks; returns `(S,)`."""
        x = self._check_readings(x)
        out = np.empty(x.shape[0], dtype=np.int32)
        for s in range(0, x.shape[0], self.max_batch):
            chunk = x[s: s + self.max_batch]
            out[s: s + chunk.shape[0]] = self._dispatch(chunk)
        return out

    def classify_batch(self, x: np.ndarray) -> np.ndarray:
        """One `(B <= max_batch, F)` batch -> labels."""
        return self._dispatch(self._check_batch(x))

    def prepare_packed_batch(self, x: np.ndarray
                             ) -> tuple[torch.Tensor, int]:
        """One `(B <= max_batch, F)` batch -> packed int32 word plane.

        Validates, binarizes through the program's thresholds (or takes raw
        bits when there are none), zero-pads to `max_batch` rows and packs
        to the `(F, max_batch/32)` plane on the program's device.  Returns
        `(words, B)`; the caller slices the decoded labels back to `B` rows.
        """
        x = self._check_batch(x)
        B = x.shape[0]
        xbin = (self.program.binarize(x)
                if self.program.thresholds is not None
                else torch.as_tensor(np.asarray(x, dtype=np.uint8)))
        xbin = xbin.to(self.program.device)
        if B < self.max_batch:
            xbin = torch.cat([xbin, xbin.new_zeros(
                (self.max_batch - B, xbin.shape[1]))])
        return self.program.pack_input_bits(xbin), B

    def _labels(self, x: np.ndarray) -> np.ndarray:
        if self.program.thresholds is not None:
            return self.program.predict(x)
        return self.program.predict_bits(np.asarray(x, dtype=np.uint8))

    def _dispatch(self, x: np.ndarray) -> np.ndarray:
        """One batch, padded to `max_batch` rows, through the program.

        Timed from the call to the labels on the host, so the time holds
        the host-to-device copy, the kernel and the copy back.
        """
        B = x.shape[0]
        if B < self.max_batch:
            pad = np.zeros((self.max_batch - B, x.shape[1]), dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        t0 = time.perf_counter()
        labels = self._labels(x)
        dt = time.perf_counter() - t0
        self.stats.record(B, dt)
        return labels[:B]
