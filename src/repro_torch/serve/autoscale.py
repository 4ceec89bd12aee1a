"""Fleet autoscaling + admission rate limiting as pure, clock-free logic.

The port's copy of `repro.serve.autoscale`, as it is.  Every tenant already
tracks `n_shed` (admission pressure), a dispatch-cost EMA (how expensive
a flush is right now) and queue depth (how far behind the scheduler is).
This module turns those into replica-count decisions — and adds the
token buckets that gate per-tenant admission — without owning a thread
or reading a wall clock.  Callers pass `now` / tick explicitly:

  * the fleet's `autoscale_tick()` snapshots per-tenant `TenantSignals`
    under its scheduler conditions and feeds them to `Autoscaler.observe`,
    applying the returned deltas (grow replicas built outside the lock,
    shrink only idle ones);
  * the deterministic tests drive the identical decision code with
    hand-built signals and a fake clock — bounded rounds, zero timing
    flake.

Hysteresis is round-based: a tenant must show pressure for `up_rounds`
consecutive observations before it grows, be completely idle for
`down_rounds` before it shrinks, and after any action sits out a
`cooldown_rounds` refractory period so the controller cannot thrash.
Shadow tenants (non-routable mirrors deployed by the autopilot) are
*never* scaled — their load is a copy of the incumbent's, and resizing
them would skew the promotion comparison they exist to make.
"""
from __future__ import annotations

from dataclasses import dataclass, field

QOS_CLASSES = ("guaranteed", "best_effort")


class TokenBucket:
    """Classic token bucket; `now` is always passed in, never sampled.

    `rate` tokens accrue per second up to `burst`; `take_upto` grants as
    many of the requested tokens as the bucket holds (the prefix-admission
    shape `submit_many` needs), and `retry_after_s` tells a shed caller
    when `need` tokens will next be available — the honest `retry_after_ms`
    hint for rate sheds.
    """

    def __init__(self, rate: float, burst: float, *, now: float = 0.0):
        if rate <= 0:
            raise ValueError("token bucket rate must be positive")
        if burst < 1:
            raise ValueError("token bucket burst must be >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = float(now)

    def _refill(self, now: float) -> None:
        dt = now - self._t_last
        if dt > 0:
            self._tokens = min(self.burst, self._tokens + dt * self.rate)
        self._t_last = max(self._t_last, now)

    def tokens(self, now: float) -> float:
        self._refill(now)
        return self._tokens

    def take_upto(self, n: int, now: float) -> int:
        """Consume and return min(n, whole tokens available)."""
        if n <= 0:
            return 0
        self._refill(now)
        grant = min(int(n), int(self._tokens))
        if grant > 0:
            self._tokens -= grant
        return grant

    def retry_after_s(self, need: int, now: float) -> float:
        """Seconds until `need` tokens will be available (0 if already)."""
        self._refill(now)
        deficit = max(0.0, float(need) - self._tokens)
        return deficit / self.rate


@dataclass
class AutoscaleConfig:
    """Hysteresis knobs for the replica autoscaler (all round-based)."""

    up_rounds: int = 2           # consecutive pressured rounds before grow
    down_rounds: int = 3         # consecutive idle rounds before shrink
    cooldown_rounds: int = 1     # refractory rounds after any action
    grow_step: int = 1           # replicas added per grow action
    queue_high_frac: float = 0.5  # queued/capacity above this = pressure
    shed_pressure: int = 1       # shed delta >= this per round = pressure
    cost_high_ms: float | None = None  # dispatch EMA above this = pressure

    def __post_init__(self):
        if self.up_rounds < 1 or self.down_rounds < 1:
            raise ValueError("hysteresis rounds must be >= 1")
        if self.cooldown_rounds < 0:
            raise ValueError("cooldown_rounds must be >= 0")
        if self.grow_step < 1:
            raise ValueError("grow_step must be >= 1")
        if not 0.0 < self.queue_high_frac <= 1.0:
            raise ValueError("queue_high_frac must be in (0, 1]")


@dataclass
class TenantSignals:
    """One tenant's control signals for one autoscaler round."""

    name: str
    pool_size: int
    queue_depth: int             # requests sitting in the micro-batch queue
    inflight: int                # dispatches currently executing
    shed_delta: int              # sheds recorded since the last round
    request_delta: int           # admissions since the last round
    est_dispatch_ms: float       # the tenant's dispatch-cost EMA
    max_batch: int
    max_queue: int | None
    min_replicas: int = 1
    max_replicas: int = 1
    is_shadow: bool = False


@dataclass
class _TenantScaleState:
    pressure_rounds: int = 0
    idle_rounds: int = 0
    cooldown: int = 0


@dataclass
class ScaleAction:
    """One decided resize: tenant + signed replica delta + the why."""

    name: str
    delta: int
    reason: str
    round_no: int

    def as_dict(self) -> dict:
        return {"tenant": self.name, "delta": self.delta,
                "reason": self.reason, "round": self.round_no}


class Autoscaler:
    """Round-based grow/shrink decisions with hysteresis and bounds.

    `observe` is the entire control law: feed it every tenant's signals
    for the round, get back the list of `ScaleAction`s to apply.  It is
    deterministic (no clocks, no randomness) and keeps only per-tenant
    round counters between calls, so tests can step it to a decision in
    a bounded, known number of rounds.
    """

    def __init__(self, config: AutoscaleConfig | None = None):
        self.config = config or AutoscaleConfig()
        self.round_no = 0
        self._states: dict[str, _TenantScaleState] = {}

    def _pressured(self, s: TenantSignals) -> bool:
        cfg = self.config
        if s.shed_delta >= cfg.shed_pressure:
            return True
        capacity = (s.max_queue if s.max_queue is not None
                    else s.max_batch * max(1, s.pool_size))
        if capacity > 0 and s.queue_depth >= cfg.queue_high_frac * capacity:
            return True
        if cfg.cost_high_ms is not None and s.est_dispatch_ms >= cfg.cost_high_ms:
            return True
        return False

    @staticmethod
    def _idle(s: TenantSignals) -> bool:
        return (s.queue_depth == 0 and s.inflight == 0
                and s.request_delta == 0 and s.shed_delta == 0)

    def observe(self, signals: list[TenantSignals]) -> list[ScaleAction]:
        cfg = self.config
        self.round_no += 1
        actions: list[ScaleAction] = []
        seen = set()
        for s in signals:
            seen.add(s.name)
            if s.is_shadow:
                # shadows mirror the incumbent's traffic; never resize them
                self._states.pop(s.name, None)
                continue
            st = self._states.setdefault(s.name, _TenantScaleState())
            if st.cooldown > 0:
                st.cooldown -= 1
                st.pressure_rounds = 0
                st.idle_rounds = 0
                continue
            if self._pressured(s):
                st.pressure_rounds += 1
                st.idle_rounds = 0
            elif self._idle(s):
                st.idle_rounds += 1
                st.pressure_rounds = 0
            else:
                st.pressure_rounds = 0
                st.idle_rounds = 0
            if (st.pressure_rounds >= cfg.up_rounds
                    and s.pool_size < s.max_replicas):
                delta = min(cfg.grow_step, s.max_replicas - s.pool_size)
                actions.append(ScaleAction(s.name, delta, "pressure",
                                           self.round_no))
                st.pressure_rounds = 0
                st.cooldown = cfg.cooldown_rounds
            elif (st.idle_rounds >= cfg.down_rounds
                    and s.pool_size > max(1, s.min_replicas)):
                actions.append(ScaleAction(s.name, -1, "idle", self.round_no))
                st.idle_rounds = 0
                st.cooldown = cfg.cooldown_rounds
        # drop state for tenants that disappeared (retired / replaced away)
        for name in list(self._states):
            if name not in seen:
                del self._states[name]
        return actions

    def summary(self) -> dict:
        return {
            "round": self.round_no,
            "tracked": sorted(self._states),
            "config": {
                "up_rounds": self.config.up_rounds,
                "down_rounds": self.config.down_rounds,
                "cooldown_rounds": self.config.cooldown_rounds,
                "grow_step": self.config.grow_step,
                "queue_high_frac": self.config.queue_high_frac,
                "shed_pressure": self.config.shed_pressure,
                "cost_high_ms": self.config.cost_high_ms,
            },
        }
