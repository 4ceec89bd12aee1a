"""Process-pool island executor — multi-core campaign stepping.

The port of `repro.evolve.executor`.  Workers are spawned, never forked
(a process whose CUDA runtime is initialised cannot fork), and each
worker of a problem on the card is one more CUDA context: the parent
builds the kernel library first (`kernels._build.build`), so the children
load one library instead of racing nvcc on `build/`.

Within an epoch, islands are embarrassingly parallel: each island's next
`gens_per_epoch` generations depend only on its own `NSGA2State` (pop,
objectives, mid-stream RNG).  Islands interact *only* at the epoch
boundary — archive fold + ring migration — which stays in the parent.
So an epoch can fan islands out over a spawned process pool and remain
bit-identical to serial stepping:

  * per-island RNG streams travel with the state
    (`encode_rng_state`/`decode_rng_state`, the checkpoint codec);
  * the shared fitness memo is pure row-independent memoization
    (`campaign.py`'s own resume contract) — per-worker caches change
    which rows hit the wrapped objective, never the values returned;
  * generation order within one island is serial either way (serial
    stepping interleaves islands generation-major, workers run each
    island epoch-major — indistinguishable because islands are
    independent between sync points).

Workers rebuild the objective from a picklable `ProblemSpec` once per
process (spawn initializer) — TNN problems ride the content-addressed
phase cache, so a worker boot costs a cache load, not a retrain — and
keep their own bounded `_memoized` cache across tasks and epochs.

Pinned by tests/test_torch_evolve.py: identical archive X/F arrays and island
histories across 1/2/4 workers, and the executor path survives the
existing SIGKILL-resume tests (checkpointing is unchanged — the parent
owns states, archive and the manifest exactly as before).
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from repro_torch.core.nsga2 import (NSGA2Driver, NSGA2State, _memoized,
                                    decode_rng_state, encode_rng_state)
from repro_torch.evolve.config import CampaignConfig
from repro_torch.evolve.problems import ProblemSpec, build_problem
from repro_torch.kernels import cuda_circuit_sim as CK

# Per-worker-process globals, installed by `_worker_init` (spawn context:
# each worker imports fresh, so this dict is private per process).
_WORKER: dict = {}


def _pack_state(s: NSGA2State) -> tuple:
    return (np.ascontiguousarray(s.pop), np.ascontiguousarray(s.F),
            int(s.generation), encode_rng_state(s.rng),
            [tuple(h) for h in s.history])


def _unpack_state(t: tuple) -> NSGA2State:
    pop, F, generation, rng_state, history = t
    return NSGA2State(pop=np.asarray(pop, dtype=np.int64),
                      F=np.asarray(F, dtype=np.float64),
                      generation=int(generation),
                      rng=decode_rng_state(rng_state),
                      history=[tuple(h) for h in history])


def _worker_init(spec: ProblemSpec, cfg: CampaignConfig) -> None:
    from repro_torch.kernels.dispatch import configure_worker_process

    configure_worker_process(max(1, cfg.workers))
    problem = build_problem(spec)
    evaluate = (_memoized(problem.objective, maxsize=cfg.memo_maxsize)
                if cfg.base.dedup_eval else problem.objective)
    _WORKER.update(problem=problem, cfg=cfg, evaluate=evaluate, drivers={},
                   cache_epoch=0, drift_applied=0)


def _sync_worker(cache_epoch: int, drift_rounds: tuple) -> None:
    """Bring this worker's objective/memo up to the parent's data epoch.

    Drift and cache invalidation happen in the parent between epochs; a
    worker cannot be *told* (tasks are pulled, not addressed), so every
    step task carries the parent's cache-epoch counter and full drift
    round history, and the worker catches up lazily before stepping.
    Drift hooks compose across rounds (each call advances the sample
    plane from where the last left it), so the worker replays exactly
    the suffix of rounds it has not applied yet — deterministic:
    `problem.drift` is a pure function of the round sequence, so any
    worker replaying the same rounds lands on the same data.
    """
    applied = _WORKER["drift_applied"]
    if len(drift_rounds) > applied:
        problem = _WORKER["problem"]
        if problem.drift is None:
            raise RuntimeError("parent drifted but worker problem has no "
                               "drift hook — ProblemSpec out of sync")
        for r in drift_rounds[applied:]:
            problem.drift(r)
        _WORKER["drift_applied"] = len(drift_rounds)
    if cache_epoch != _WORKER["cache_epoch"]:
        clear = getattr(_WORKER["evaluate"], "cache_clear", None)
        if clear is not None:
            clear()
        _WORKER["cache_epoch"] = cache_epoch


def _step_island(island: int, payload: tuple, gens: int,
                 cache_epoch: int = 0, drift_rounds: tuple = ()
                 ) -> tuple:
    _sync_worker(cache_epoch, drift_rounds)
    cfg: CampaignConfig = _WORKER["cfg"]
    driver = _WORKER["drivers"].get(island)
    if driver is None:
        problem = _WORKER["problem"]
        driver = NSGA2Driver(problem.domains, problem.objective,
                             cfg.island_nsga2(island),
                             evaluate=_WORKER["evaluate"])
        _WORKER["drivers"][island] = driver
    state = _unpack_state(payload)
    for _ in range(gens):
        state = driver.step(state)
    info = getattr(_WORKER["evaluate"], "cache_info", lambda: {})()
    if info:
        info = {**info, "pid": os.getpid()}
    return island, _pack_state(state), info


class IslandExecutor:
    """Steps a campaign's islands concurrently on spawned workers.

    One executor serves one campaign for its lifetime; `close()` (or use
    as a context manager) tears the pool down.  `n_workers` may exceed
    the island count — extra workers idle.
    """

    def __init__(self, spec: ProblemSpec, cfg: CampaignConfig,
                 n_workers: int | None = None):
        if not isinstance(spec, ProblemSpec):
            raise TypeError("IslandExecutor needs a picklable ProblemSpec "
                            "(raw objective callables cannot cross the "
                            "process boundary)")
        import multiprocessing as mp

        self.n_workers = int(n_workers or cfg.workers or
                             min(cfg.n_islands, os.cpu_count() or 1))
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if spec.kind == "tnn":
            CK.build_before_spawn([spec.kwargs.get("device")])
        self._pool = ProcessPoolExecutor(
            max_workers=self.n_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_worker_init, initargs=(spec, cfg))
        self._cache_epoch = 0
        self._drift_rounds: tuple[int, ...] = ()

    def step_islands(self, states: list[NSGA2State], gens: int
                     ) -> tuple[list[NSGA2State], dict]:
        """Advance every island `gens` generations; returns (states, stats).

        `stats` aggregates the workers' fitness-memo counters (cumulative
        per worker — the campaign diffs them per epoch).
        """
        futs = [self._pool.submit(_step_island, i, _pack_state(s), gens,
                                  self._cache_epoch, self._drift_rounds)
                for i, s in enumerate(states)]
        out: list[NSGA2State | None] = [None] * len(states)
        # one worker may step several islands and reports its cumulative
        # counters once per island — keep only the most advanced report
        # per worker pid (counters are monotonic), then sum across pids
        per_pid: dict[int, dict] = {}
        for fut in futs:
            island, payload, info = fut.result()
            out[island] = _unpack_state(payload)
            if info:
                pid = info["pid"]
                best = per_pid.get(pid)
                if (best is None or info["hits"] + info["misses"]
                        >= best["hits"] + best["misses"]):
                    per_pid[pid] = info
        agg = {"hits": 0, "misses": 0, "evictions": 0, "size": 0}
        for info in per_pid.values():
            for k in agg:
                agg[k] += int(info.get(k, 0))
        agg["workers"] = self.n_workers
        agg["reports"] = len(per_pid)
        return out, agg

    def clear_eval_cache(self) -> None:
        """Invalidate every worker's fitness memo (post-drift hygiene).

        Tasks are pulled by whichever worker frees up first, so a clear
        cannot be *pushed*; instead the executor bumps a cache-epoch
        counter that rides along with every subsequent step task, and
        each worker clears lazily the first time it sees the new value —
        guaranteed to land before that worker evaluates another row.
        """
        self._cache_epoch += 1

    def mark_drift(self, round_idx: int) -> None:
        """Record that the parent applied `problem.drift(round_idx)`.

        Workers replay the same deterministic drift sequence before
        their next step (see `_sync_worker`) so their sample planes
        match the parent's.  Implies a cache invalidation.
        """
        self._drift_rounds = self._drift_rounds + (int(round_idx),)
        self.clear_eval_cache()

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "IslandExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
